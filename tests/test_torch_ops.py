"""The port's math core (``basd_tpu_torch/ops``) against the JAX package's
on the same inputs: interpolation, MP rank, the secular rank-one update,
the degeneracy-safe eigh backward, Newton-Schulz polar and the nuclear
norm."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from basd_tpu.ops import interp as jinterp
from basd_tpu.ops import linalg as jlinalg
from basd_tpu.ops import mp_rank as jmp
from basd_tpu_torch.ops import interp, linalg, mp_rank

RNG = np.random.default_rng(17)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("src,dst", [(16, 16), (16, 49), (196, 64)])
def test_linear_interp_matches_jax(src, dst):
    x = RNG.standard_normal((3, src, 5)).astype(np.float32)
    ref = jinterp.linear_interp1d(jnp.asarray(x), dst, axis=1)
    out = interp.linear_interp1d(torch.from_numpy(x), dst, axis=1)
    assert _rel(out.numpy(), ref) <= 1e-6


def test_mp_rank_and_rank_one_update_match_jax():
    m, d = 300, 24
    z = (RNG.standard_normal((2, m, 5)) @ RNG.standard_normal((5, d)) * 3
         + RNG.standard_normal((2, m, d))).astype(np.float32)
    ref = jmp.marchenko_pastur_rank(jnp.asarray(z))
    out = mp_rank.marchenko_pastur_rank(torch.from_numpy(z))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert int(out.min()) > 0

    zc = z[0] - z[0].mean(0)
    w, v = np.linalg.eigh((zc.T @ zc).astype(np.float64))
    mu = z[0].mean(0)
    args = (w[None].astype(np.float32), (v.T @ mu)[None].astype(np.float32))
    ref = jlinalg.rank_one_update_eigvals(*map(jnp.asarray, args), float(m))
    out = linalg.rank_one_update_eigvals(*map(torch.from_numpy, args), float(m))
    assert _rel(out.numpy(), ref) <= 1e-5


def test_safe_eigh_backward_matches_jax():
    a = RNG.standard_normal((3, 12, 12)).astype(np.float32)
    a = a @ a.transpose(0, 2, 1)
    a[0, :, :] = np.eye(12, dtype=np.float32)  # fully degenerate: clamped
    wgt = RNG.standard_normal((12, 12)).astype(np.float32)

    def jf(x):
        w, v = jlinalg.safe_eigh_desc(x)
        return jnp.sum(w ** 2) + jnp.sum(jnp.abs(v[..., :3]) * wgt[:, :3])

    def tf(x):
        w, v = linalg.safe_eigh_desc(x)
        return (w ** 2).sum() + (v[..., :3].abs() * torch.from_numpy(wgt[:, :3])).sum()

    ref = jax.grad(jf)(jnp.asarray(a))
    x = torch.from_numpy(a).requires_grad_(True)
    (g,) = torch.autograd.grad(tf(x), x)
    assert np.isfinite(g.numpy()).all()
    # matrix 0 is degenerate: any eigenbasis is valid there, so it is
    # checked for a finite (clamped) gradient only
    assert _rel(g[1:].numpy(), np.asarray(ref)[1:]) <= 1e-3


@pytest.mark.parametrize("schedule,inner", [("cubic", "float32"),
                                            ("hybrid", "float32"),
                                            ("hybrid", "bfloat16")])
def test_newton_schulz_polar_matches_jax(schedule, inner):
    m = RNG.standard_normal((4, 24, 40)).astype(np.float32)
    ref = jlinalg.newton_schulz_polar(jnp.asarray(m), inner_dtype=getattr(jnp, inner),
                                      schedule=schedule)
    out = linalg.newton_schulz_polar(torch.from_numpy(m),
                                     inner_dtype=getattr(torch, inner),
                                     schedule=schedule)
    tol = 1e-4 if inner == "float32" else 3e-2
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=tol)


def test_nuclear_norm_value_and_grad_match_jax():
    m = RNG.standard_normal((3, 16, 24)).astype(np.float32)
    ref_v, ref_g = jax.value_and_grad(lambda x: jnp.sum(jlinalg.nuclear_norm(x)))(
        jnp.asarray(m))
    x = torch.from_numpy(m).requires_grad_(True)
    v = linalg.nuclear_norm(x).sum()
    (g,) = torch.autograd.grad(v, x)
    assert _rel(v.item(), float(ref_v)) <= 1e-5
    ref_s = np.linalg.svd(m.astype(np.float64), compute_uv=False).sum()
    assert _rel(v.item(), ref_s) <= 1e-5
    # the backward is the bf16 Newton-Schulz polar factor in both packages
    np.testing.assert_allclose(g.numpy(), np.asarray(ref_g), atol=3e-2)
