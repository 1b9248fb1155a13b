"""The port's BASD loss (selector + identity-form Procrustes + CE + UW-SO)
against the JAX package's, f32, same selector state, same inputs: value
and gradients for the student tokens, the logits and the temperatures, on
the packed (CLS-kept flat collection) and the dense teacher branches.

The Procrustes polar factor runs in bf16 in both packages, and bf16
roundings flipped by a different f32 summation order are amplified by the
accelerated Newton-Schulz steps (the reference documents ~1% error in the
gradient direction, basd_tpu/ops/linalg.py:284-288). So the tight checks
run the polar in f32 on both sides (``polar_inner``), isolating the loss
math; the bf16 polar itself is held against the JAX kernel in
test_torch_kernels.py, and one case here keeps it at the reference's 1%.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from basd_tpu.losses import combined as jcombined
from basd_tpu.models.tokens import pack_dense as jpack_dense
from basd_tpu_torch.losses import combined
from basd_tpu_torch.models.port import selector_state_from_jax
from basd_tpu_torch.models.tokens import pack_dense

L, P, B, N, DT, DS, C = 4, 4, 8, 16, 64, 32, 10


def _spread(rng, m, d, top):
    """(m, d) tokens whose covariance spectrum falls geometrically over a
    factor 30: MP ranks > 0, and eigenvalue gaps wide enough that the
    eigenvector derivatives (1/gap) are well conditioned in f32."""
    q = np.linalg.qr(rng.standard_normal((d, d)))[0]
    return (rng.standard_normal((m, d)) * np.geomspace(top, top / 30, d)) @ q


def _inputs(seed):
    rng = np.random.default_rng(seed)
    t = np.stack([_spread(rng, B * (N + 1), DT, 3 + i) for i in range(L)]
                 ).reshape(L, B, N + 1, DT).astype(np.float32)
    t[..., 3] += 5.0  # an outlier channel mean, as in real ViT streams
    s = np.stack([_spread(rng, B * N, DS, 2 + i) for i in range(P)]
                 ).reshape(P, B, N, DS).astype(np.float32)
    imp = rng.uniform(0.1, 1.0, (L, B, N)).astype(np.float32)
    logits = rng.standard_normal((B, C)).astype(np.float32)
    targets = rng.dirichlet(np.ones(C), B).astype(np.float32)
    return t, s, imp, logits, targets


def _cfgs():
    kw = dict(student_dim=DS, teacher_dim=DT, student_depth=4,
              num_student_tokens=N, num_extraction_points=P,
              label_smoothing=0.1, teacher_has_cls_token=True)
    return jcombined.BASDLossConfig(**kw), combined.BASDLossConfig(**kw)


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _polar_inner(monkeypatch, inner: str):
    """Run both packages' polar factor with ``inner`` operands."""
    from basd_tpu.ops import linalg as jlinalg
    from basd_tpu_torch.ops import linalg

    monkeypatch.setattr(jlinalg, "newton_schulz_polar", functools.partial(
        jlinalg.newton_schulz_polar, inner_dtype=getattr(jnp, inner)))
    monkeypatch.setattr(linalg, "newton_schulz_polar", functools.partial(
        linalg.newton_schulz_polar, inner_dtype=getattr(torch, inner)))


# (packed teacher, polar inner dtype, value tol, grad tol)
CASES = [(True, "float32", 1e-4, 1e-3), (False, "float32", 1e-4, 1e-3),
         (True, "bfloat16", 1e-3, 5e-2)]


@pytest.mark.parametrize("packed,inner,vtol,gtol", CASES)
def test_basd_loss_value_and_grads_match_jax(monkeypatch, packed, inner,
                                             vtol, gtol):
    _polar_inner(monkeypatch, inner)
    t, s, imp, logits, targets = _inputs(4 if packed else 5)
    jcfg, cfg = _cfgs()
    jparams, jbuffers = jcombined.init_basd_loss(jax.random.PRNGKey(2), jcfg)
    params, buffers = selector_state_from_jax(jparams, jbuffers)
    if packed:
        jt = jpack_dense(jnp.asarray(t), has_cls=True)
        tt = pack_dense(torch.from_numpy(t), has_cls=True)
    else:
        jt, tt = jnp.asarray(t[:, :, 1:]), torch.from_numpy(t[:, :, 1:].copy())

    def jloss(s_, logits_, lt):
        return jcombined.basd_loss({"log_temperatures": lt}, jbuffers, logits_,
                                   jnp.asarray(targets), s_, jt,
                                   jnp.asarray(imp), jcfg)

    (jval, jaux), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(s), jnp.asarray(logits), jparams["log_temperatures"])

    s_t = torch.from_numpy(s).requires_grad_(True)
    logits_t = torch.from_numpy(logits).requires_grad_(True)
    lt = params["log_temperatures"].clone().requires_grad_(True)
    val, aux = combined.basd_loss({"log_temperatures": lt}, buffers, logits_t,
                                  torch.from_numpy(targets), s_t, tt,
                                  torch.from_numpy(imp), cfg)
    grads = torch.autograd.grad(val, (s_t, logits_t, lt))

    np.testing.assert_array_equal(aux["ranks"].numpy(), np.asarray(jaux["ranks"]))
    assert int(aux["ranks"].min()) > 0
    assert abs(val.item() - float(jval)) <= vtol * abs(float(jval))
    for name in ("ce_loss", "geo_loss"):
        assert _rel(aux[name].detach().numpy(), np.asarray(jaux[name])) <= vtol, name
    for g, jg, name in zip(grads, jgrads, ("student", "logits", "temps")):
        assert _rel(g.numpy(), np.asarray(jg)) <= gtol, name


def test_ident_core_grads_match_jax(monkeypatch):
    """The closed-form Procrustes backward against the JAX custom VJP."""
    from basd_tpu.ops import procrustes as jpro

    _polar_inner(monkeypatch, "float32")
    from basd_tpu_torch.ops import procrustes

    rng = np.random.default_rng(9)
    s = rng.standard_normal((3, N, DS)).astype(np.float32)
    t = (rng.standard_normal((3, N, DT)) + 2.0).astype(np.float32)
    w = rng.uniform(0.1, 1.0, (3, N)).astype(np.float32)
    jf = lambda a, b, c: jnp.sum(jpro.geometric_relational_loss_ident(a, b, c))  # noqa: E731
    jval, jg = jax.value_and_grad(jf, argnums=(0, 1, 2))(
        jnp.asarray(s), jnp.asarray(t), jnp.asarray(w))
    args = [torch.from_numpy(a).requires_grad_(True) for a in (s, t, w)]
    val = procrustes.geometric_relational_loss_ident(*args).sum()
    grads = torch.autograd.grad(val, args)
    assert abs(val.item() - float(jval)) <= 1e-4 * abs(float(jval))
    for g, r in zip(grads, jg):
        assert _rel(g.numpy(), np.asarray(r)) <= 1e-3
