"""The port's other spectral backends against the JAX package's, f32, same
numpy inputs: K8's plain version (``jacobi_eigh_plain``) against the
Pallas Jacobi kernel in interpret mode, the 'jacobi' and 'svd' dispatch of
``ops.linalg``, ``ops.mp_rank`` and ``ops.grassmann``, the composed
Procrustes loss and the ident form's svd/eigh branch, ``select_and_mix``
and ``basd_loss`` under (jacobi, ident), (svd, composed) and (gram,
composed), and the CLI on the CPU under each.

Tolerances, and why: both packages run 6 Jacobi sweeps (the backend's
count), which on these spectra leaves an off-diagonal residual of ~1e-4
of the spectral scale (``tests/test_jacobi.py:96-118`` measures 1.5e-4 on
the selector's own structure); two implementations that round differently
(fused multiply-adds, products against constant matrices) stop at
different residuals, so at n = 96 their eigenvalues agree to ~1e-4 of the
scale at 6 sweeps and ~5e-5 at 12, not to f32 epsilon. Losses and gradients use the
f32 polar factor on both sides, as in test_torch_losses.py.
"""

from __future__ import annotations

import json
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from basd_tpu.losses import combined as jcombined
from basd_tpu.losses import selector as jselector
from basd_tpu.models.tokens import pack_dense as jpack_dense
from basd_tpu.ops import grassmann as jgrassmann
from basd_tpu.ops import linalg as jlinalg
from basd_tpu.ops import mp_rank as jmp
from basd_tpu.ops import procrustes as jpro
from basd_tpu.ops.pallas.jacobi_eigh import jacobi_eigh as jjacobi
from basd_tpu_torch.kernels.jacobi_eigh import (
    jacobi_eigh,
    jacobi_eigh_plain,
    pair_table,
)
from basd_tpu_torch.losses import combined, selector
from basd_tpu_torch.models.port import selector_state_from_jax
from basd_tpu_torch.models.tokens import PackedTokens, pack_dense
from basd_tpu_torch.ops import grassmann, linalg, mp_rank, procrustes
from basd_tpu_torch.train import main

from .test_torch_losses import B, DS, DT, N, P, _inputs, _polar_inner, _rel


def _sym(rng, bsz, n):
    x = rng.standard_normal((bsz, n, n))
    return ((x + x.transpose(0, 2, 1)) / 2).astype(np.float32)


def _principal_angle_grams(rng, bsz, r):
    """Masked cross-basis Grams of random orthonormal (2r, r) bases, ranks
    88-96% of r: spectra clustered in [0, 1] with exact zeros, the
    selector's principal-angle structure (``tests/test_jacobi.py:96-118``)."""
    mats = []
    for _ in range(bsz):
        us = np.linalg.qr(rng.standard_normal((2 * r, r)))[0]
        ut = np.linalg.qr(rng.standard_normal((2 * r, r)))[0]
        k = rng.integers(int(0.88 * r), int(0.96 * r) + 1)
        mask = (np.arange(r) < k).astype(np.float64)
        gm = mask[:, None] * (us.T @ ut) * mask[None, :]
        mats.append(gm.T @ gm)
    return np.stack(mats).astype(np.float32)


# ---- K8: the plain version against the Pallas kernel ----------------------

@pytest.mark.parametrize("n", [4, 8, 16, 96])
def test_pair_table_rounds_are_disjoint_and_cover_every_pair(n):
    table = pair_table(n)
    assert table.shape == (n - 1, n // 2, 2)
    seen = set()
    for r in range(n - 1):
        assert sorted(table[r].ravel().tolist()) == list(range(n))
        seen.update((min(p, q), max(p, q)) for p, q in table[r].tolist())
    assert len(seen) == n * (n - 1) // 2


def _slot_rule_pairs(n):
    """The pairs the TPU kernel rotates, read off its own permutation
    matrices (``jacobi_eigh.py:103-117``): slot j pairs with slot j + n/2,
    and the state's slots are permuted by P after each round."""
    m = n // 2
    row, col = np.indices((n, n))
    perm = (((col == 0) & (row == 0)) | ((col == 1) & (row == m))
            | ((col >= 2) & (col <= m - 1) & (row == col - 1))
            | ((col >= m) & (col <= n - 2) & (row == col + 1))
            | ((col == n - 1) & (row == m - 1))).astype(np.int64)
    holds = np.eye(n, dtype=np.int64)  # holds[i, s] = slot s holds index i
    rounds = []
    for _ in range(n - 1):
        idx = holds.argmax(0)
        rounds.append(np.stack([idx[:m], idx[m:]], -1))
        holds = holds @ perm
    return np.stack(rounds), holds


@pytest.mark.parametrize("n", [4, 12, 96])
def test_pair_table_is_the_tpu_kernels_slot_rule(n):
    rounds, holds = _slot_rule_pairs(n)
    np.testing.assert_array_equal(pair_table(n), rounds)
    # after a whole sweep every slot holds its own index again
    np.testing.assert_array_equal(holds, np.eye(n))


def _scale(w):
    return max(float(np.abs(w).max()), 1e-30)


@pytest.mark.parametrize("sweeps", [6, 12])
@pytest.mark.parametrize("structure", ["random", "principal"])
@pytest.mark.parametrize("n", [8, 32, 96])
def test_jacobi_plain_matches_pallas_kernel(n, structure, sweeps):
    rng = np.random.default_rng(n + sweeps)
    a = (_sym(rng, 3, n) if structure == "random"
         else _principal_angle_grams(rng, 3, n))
    jw, jv = map(np.asarray, jjacobi(jnp.asarray(a), sweeps=sweeps,
                                     interpret=True))
    w, v = (x.numpy() for x in jacobi_eigh_plain(torch.from_numpy(a), sweeps))
    # measured: up to 1.2e-4 of the scale at n = 96 after 6 sweeps (the
    # principal-angle clusters), 5e-5 after 12, below 1e-5 for n <= 32
    tol = 3e-4 if sweeps == 6 else 1e-4
    assert np.abs(w - jw).max() <= tol * _scale(jw)
    # eigenvectors up to sign, where the eigenvalue is separated from its
    # neighbours by 2% of the scale (the principal-angle spectra cluster)
    gaps = np.diff(jw, axis=-1)
    gap = np.minimum(np.pad(gaps, ((0, 0), (1, 0)), constant_values=np.inf),
                     np.pad(gaps, ((0, 0), (0, 1)), constant_values=np.inf))
    sep = gap > 0.02 * _scale(jw)
    assert sep.sum() >= 4
    dots = np.abs(np.einsum("bij,bij->bj", v, jv))[sep]
    assert dots.min() >= 1.0 - 1e-4
    rec = np.einsum("bik,bk,bjk->bij", v.astype(np.float64), w, v)
    assert np.abs(rec - a).max() <= 2 * tol * _scale(jw)


@pytest.mark.parametrize("structure", ["projector", "shared_subspace"])
def test_jacobi_degenerate_cluster(structure):
    """Where eigenvalues coincide, K8's one orthogonal rotation per pair
    stays at the f32 floor: here within 2e-5 of float64 LAPACK. The Pallas
    kernel evaluates the rotation a second time for the bottom slot from
    a_qp; with A symmetric only to the last bit its J stops being
    orthogonal on such clusters, and on these inputs its eigenvalues end
    2.5e-3 (projector) and 3.4e-3 (shared subspace) off after 6 sweeps,
    further after 12: recorded here as the reference's behaviour, which
    the port does not copy."""
    rng = np.random.default_rng(8)
    if structure == "projector":  # rank 24 of 32, all nonzero eigenvalues 1
        q = np.linalg.qr(rng.standard_normal((4, 32, 32)))[0]
        a = np.einsum("bik,k,bjk->bij", q, np.r_[np.ones(24), np.zeros(8)], q)
    else:  # principal-angle Gram of nearly the same subspaces
        us = np.linalg.qr(rng.standard_normal((4, 64, 32)))[0]
        ut = np.linalg.qr(us + 1e-3 * rng.standard_normal((4, 64, 32)))[0]
        mask = (np.arange(32) < 28).astype(np.float64)
        gm = mask[:, None] * np.einsum("bki,bkj->bij", us, ut) * mask[None, :]
        a = np.einsum("bki,bkj->bij", gm, gm)
    a = a.astype(np.float32)
    w, v = jacobi_eigh_plain(torch.from_numpy(a), 6)
    ref = np.linalg.eigvalsh(a.astype(np.float64))
    assert np.abs(w.numpy() - ref).max() <= 2e-5
    vtv = np.einsum("bki,bkj->bij", v.numpy().astype(np.float64), v.numpy())
    assert np.abs(vtv - np.eye(32)).max() <= 2e-5
    jw = np.asarray(jjacobi(jnp.asarray(a), sweeps=6, interpret=True)[0])
    assert np.abs(jw - ref).max() >= 1e-3


def test_jacobi_odd_n_raises():
    a = torch.zeros((2, 7, 7))
    with pytest.raises(ValueError):
        jacobi_eigh_plain(a, 6)
    with pytest.raises(ValueError):
        jacobi_eigh(a, 6)
    with pytest.raises(AssertionError):
        jjacobi(jnp.zeros((2, 7, 7)), sweeps=6, interpret=True)


# ---- ops: linalg, mp_rank, grassmann -------------------------------------

def _well_separated_psd(rng, bsz, n):
    q = np.linalg.qr(rng.standard_normal((bsz, n, n)))[0]
    w = np.stack([rng.permutation(np.linspace(1.0, 3.0, n)) for _ in range(bsz)])
    return np.einsum("bik,bk,bjk->bij", q, w, q).astype(np.float32)


def _eigvalsh_case(rng, backend):
    a = _well_separated_psd(rng, 3, 16)
    c = rng.standard_normal((3, 16)).astype(np.float32)
    return ((a,),
            lambda x: jnp.sum(jlinalg.eigvalsh_only(x, backend) * c),
            lambda x: (linalg.eigvalsh_only(x, backend) * torch.from_numpy(c)).sum())


def _safe_eigh_case(rng, backend):
    a = _well_separated_psd(rng, 3, 16)
    wgt = rng.standard_normal((16, 3)).astype(np.float32)

    def jf(x):
        w, v = jlinalg.safe_eigh_desc(x, backend)
        return jnp.sum(w ** 2) + jnp.sum(jnp.abs(v[..., :3]) * wgt)

    def tf(x):
        w, v = linalg.safe_eigh_desc(x, backend)
        return (w ** 2).sum() + (v[..., :3].abs() * torch.from_numpy(wgt)).sum()

    return (a,), jf, tf


def _singular_values_case(rng, backend):
    m = rng.standard_normal((3, 12, 20)).astype(np.float32)
    c = rng.standard_normal((3, 12)).astype(np.float32)
    return ((m,),
            lambda x: jnp.sum(jlinalg.singular_values(x, backend) * c),
            lambda x: (linalg.singular_values(x, backend) * torch.from_numpy(c)).sum())


def _right_singular_vectors_case(rng, backend):
    x = (rng.standard_normal((3, 40, 12)) * np.geomspace(3, 0.3, 12)).astype(np.float32)
    wgt = rng.standard_normal((12, 3)).astype(np.float32)

    def jf(z):
        s, v = jlinalg.right_singular_vectors(z, backend)
        return jnp.sum(s) + jnp.sum(jnp.abs(v[..., :3]) * wgt)

    def tf(z):
        s, v = linalg.right_singular_vectors(z, backend)
        return s.sum() + (v[..., :3].abs() * torch.from_numpy(wgt)).sum()

    return (x,), jf, tf


# (case constructor, backend / impl)
LINALG_CASES = [
    (_eigvalsh_case, "jacobi"),
    (_safe_eigh_case, "jacobi"),
    (_singular_values_case, "jacobi"),
    (_singular_values_case, "svd"),
    (_right_singular_vectors_case, "jacobi"),
    (_right_singular_vectors_case, "svd"),
]


@pytest.mark.parametrize("case,backend", LINALG_CASES,
                         ids=[f"{c.__name__[1:-5]}-{b}" for c, b in LINALG_CASES])
def test_linalg_backends_match_jax(case, backend):
    """Value 1e-4 and gradient 5e-4 relative: after 6 sweeps the Jacobi
    eigenvectors carry the residual over the eigenvalue gap (measured
    1.2e-4 in the gradients); svd is LAPACK on both sides (measured 4e-5
    in a value whose terms cancel)."""
    args, jf, tf = case(np.random.default_rng(11), backend)
    jval, jgrad = jax.value_and_grad(jf)(*map(jnp.asarray, args))
    x = torch.from_numpy(args[0]).requires_grad_(True)
    val = tf(x)
    (grad,) = torch.autograd.grad(val, x)
    assert _rel(val.item(), float(jval)) <= 1e-4
    assert _rel(grad.numpy(), np.asarray(jgrad)) <= 5e-4


@pytest.mark.parametrize("m,d", [(300, 24), (20, 24)])
def test_mp_rank_jacobi_matches_jax(m, d):
    rng = np.random.default_rng(m)
    z = (rng.standard_normal((2, m, 5)) @ rng.standard_normal((5, d)) * 3
         + rng.standard_normal((2, m, d))).astype(np.float32)
    ref = jmp.marchenko_pastur_rank(jnp.asarray(z), impl="jacobi")
    out = mp_rank.marchenko_pastur_rank(torch.from_numpy(z), impl="jacobi")
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert int(out.min()) > 0


@pytest.mark.parametrize("backend", ["svd", "jacobi"])
def test_grassmann_backends_match_jax(backend):
    """Subspaces (singular values, basis columns up to sign) and the
    weighted principal-angle distance with its gradient into the student
    tokens, against JAX: 1e-4 relative."""
    rng = np.random.default_rng(6)
    d, m = 16, 256
    spread = np.geomspace(4.0, 0.2, d)
    # independent panels of opposite spreads and ranks below d/2: principal
    # cosines away from 1, where the angle arccos(sigma) would amplify
    # 1e-6 eigenvalue noise a hundredfold (two k-subspaces of R^d share
    # 2k - d directions: a cluster at 1 is test_jacobi_degenerate_cluster's)
    z_s = (rng.standard_normal((2, m, d)) * spread).astype(np.float32)
    z_t = (rng.standard_normal((2, m, d)) * spread[::-1]).astype(np.float32)
    mask = np.stack([(np.arange(d) < k) for k in (5, 7)]).astype(np.float32)

    jb, js = jgrassmann.grassmann_subspace(jnp.asarray(z_t), backend=backend)
    b, s = grassmann.grassmann_subspace(torch.from_numpy(z_t), backend=backend)
    assert _rel(s.numpy(), np.asarray(js)) <= 1e-4
    dots = np.abs(np.einsum("bij,bij->bj", b.numpy(), np.asarray(jb)))
    assert dots.min() >= 1.0 - 1e-4

    def jf(zs):
        bs, _ = jgrassmann.grassmann_subspace(zs, backend=backend)
        return jnp.sum(jgrassmann.spectral_grassmann_distance_sq(
            bs, jb, js, jnp.asarray(mask), backend=backend))

    def tf(zs):
        bs, _ = grassmann.grassmann_subspace(zs, backend=backend)
        return grassmann.spectral_grassmann_distance_sq(
            bs, b, s, torch.from_numpy(mask), backend=backend).sum()

    jval, jgrad = jax.value_and_grad(jf)(jnp.asarray(z_s))
    x = torch.from_numpy(z_s).requires_grad_(True)
    val = tf(x)
    (grad,) = torch.autograd.grad(val, x)
    assert _rel(val.item(), float(jval)) <= 1e-4
    assert _rel(grad.numpy(), np.asarray(jgrad)) <= 1e-3


# ---- the Procrustes loss: composed form, ident svd/eigh branch -----------

def _procrustes_inputs(seed, n=48):
    """More tokens than D_s, so the cross-covariance has full rank: the
    'eigh' nuclear norm takes square roots of its Gram eigenvalues, and of
    an exact zero that is sqrt(f32 noise), different in each package."""
    rng = np.random.default_rng(seed)
    s = (rng.standard_normal((3, n, DS)) * np.geomspace(3, 0.3, DS)).astype(np.float32)
    t = (rng.standard_normal((3, n, DT)) + 2.0).astype(np.float32)
    w = rng.uniform(0.1, 1.0, (3, n)).astype(np.float32)
    return s, t, w


@pytest.mark.parametrize("form,nuclear_backend", [
    ("composed", "svd"), ("composed", "eigh"), ("composed", "gram"),
    ("ident", "svd"), ("ident", "eigh")])
def test_procrustes_forms_match_jax(monkeypatch, form, nuclear_backend):
    """Value (1e-4) and the gradients of s, t and w (1e-3) against JAX,
    f32 polar factor on both sides."""
    _polar_inner(monkeypatch, "float32")
    s, t, w = _procrustes_inputs(9)
    jfn = (jpro.geometric_relational_loss if form == "composed"
           else jpro.geometric_relational_loss_ident)
    fn = (procrustes.geometric_relational_loss if form == "composed"
          else procrustes.geometric_relational_loss_ident)
    jval, jgrads = jax.value_and_grad(
        lambda *a: jnp.sum(jfn(*a, nuclear_backend=nuclear_backend)),
        argnums=(0, 1, 2))(*map(jnp.asarray, (s, t, w)))
    args = [torch.from_numpy(a).requires_grad_(True) for a in (s, t, w)]
    val = fn(*args, nuclear_backend=nuclear_backend).sum()
    grads = torch.autograd.grad(val, args)
    assert _rel(val.item(), float(jval)) <= 1e-4
    for g, r, name in zip(grads, jgrads, "stw"):
        assert _rel(g.numpy(), np.asarray(r)) <= 1e-3, name


# ---- the selector and the whole loss --------------------------------------

def _teachers(t, packed):
    """The JAX and the port's teacher collection of the same tokens."""
    if packed:
        return (jpack_dense(jnp.asarray(t), has_cls=True),
                pack_dense(torch.from_numpy(t), has_cls=True))
    return jnp.asarray(t[:, :, 1:]), torch.from_numpy(t[:, :, 1:].copy())


# (backend, teacher collection, max_rank, batch): 'tiny' is B=1, M = N =
# 16 < D_s = 32, the parity branch for every backend (svd there needs
# max_rank <= M, as in the JAX package); max_rank 8 binds
SELECTOR_CASES = [
    ("jacobi", "packed", None, B), ("jacobi", "dense", None, B),
    ("svd", "dense", None, B), ("svd", "packed", None, B),
    ("jacobi", "dense", None, 1), ("svd", "dense", 16, 1),
    ("jacobi", "packed", 8, B), ("svd", "dense", 8, B),
]


@pytest.mark.parametrize("backend,teacher,max_rank,bsz", SELECTOR_CASES)
def test_select_and_mix_backends_match_jax(backend, teacher, max_rank, bsz):
    """Ranks and cap hits equal; distances, mixed tokens and importance
    to 1e-4 relative."""
    t, s, imp, _, _ = _inputs(7)
    t, s, imp = t[:, :bsz], s[:, :bsz], imp[:, :bsz]
    jcfg = jselector.SelectorConfig(P, DS, DT, backend, max_rank)
    cfg = selector.SelectorConfig(P, DS, DT, backend, max_rank)
    jparams, jbuffers = jselector.init_selector(jax.random.PRNGKey(3), jcfg)
    params, buffers = selector_state_from_jax(jparams, jbuffers)
    jt, tt = _teachers(t, teacher == "packed")
    jmixed, jmimp, jaux = jselector.select_and_mix(
        jparams, jbuffers, jnp.asarray(s), jt, jnp.asarray(imp), jcfg)
    mixed, mimp, aux = selector.select_and_mix(
        params, buffers, torch.from_numpy(s), tt, torch.from_numpy(imp), cfg)

    np.testing.assert_array_equal(aux["ranks"].numpy(), np.asarray(jaux["ranks"]))
    assert int(aux["rank_cap_hits"]) == int(jaux["rank_cap_hits"])
    if max_rank == 8:
        assert int(aux["rank_cap_hits"]) > 0
    assert int(aux["ranks"].min()) > 0
    assert _rel(aux["distances_sq"].numpy(), np.asarray(jaux["distances_sq"])) <= 1e-4
    assert mixed.shape == jmixed.shape
    assert _rel(mixed.numpy(), np.asarray(jmixed)) <= 1e-4
    assert _rel(mimp.numpy(), np.asarray(jmimp)) <= 1e-4


# (backend, relational impl, packed teacher collection)
LOSS_CASES = [
    ("jacobi", "ident", True), ("jacobi", "ident", False),
    ("svd", "composed", False), ("svd", "composed", True),
    ("gram", "composed", True), ("gram", "composed", False),
]


@pytest.mark.parametrize("backend,impl,packed", LOSS_CASES)
def test_basd_loss_backends_match_jax(monkeypatch, backend, impl, packed):
    """Value (1e-4) and the gradients of the student tokens, the logits and
    the temperatures (1e-3) against JAX, f32 polar factor on both sides.
    A packed collection rides the packed path only under gram/jacobi +
    ident: otherwise the selector gets the dense stack and the composed
    loss runs once per extraction point, as in the JAX package."""
    _polar_inner(monkeypatch, "float32")
    t, s, imp, logits, targets = _inputs(4 if packed else 5)
    kw = dict(student_dim=DS, teacher_dim=DT, student_depth=4,
              num_student_tokens=N, num_extraction_points=P,
              label_smoothing=0.1, teacher_has_cls_token=True,
              backend=backend, relational_impl=impl)
    jcfg, cfg = jcombined.BASDLossConfig(**kw), combined.BASDLossConfig(**kw)
    jparams, jbuffers = jcombined.init_basd_loss(jax.random.PRNGKey(2), jcfg)
    params, buffers = selector_state_from_jax(jparams, jbuffers)
    jt, tt = _teachers(t, packed)

    seen, composed_calls = [], []
    select = combined.select_and_mix
    composed = combined.geometric_relational_loss
    monkeypatch.setattr(combined, "select_and_mix", lambda *a: (
        seen.append(type(a[3])), select(*a))[1])
    monkeypatch.setattr(combined, "geometric_relational_loss", lambda *a, **k: (
        composed_calls.append(1), composed(*a, **k))[1])

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

    fast = backend in ("gram", "jacobi") and impl == "ident"
    assert seen == [PackedTokens if packed and fast else torch.Tensor]
    assert len(composed_calls) == (0 if fast else P)
    np.testing.assert_array_equal(aux["ranks"].numpy(), np.asarray(jaux["ranks"]))
    assert abs(val.item() - float(jval)) <= 1e-4 * abs(float(jval))
    for name in ("ce_loss", "geo_loss"):
        assert _rel(aux[name].detach().numpy(), np.asarray(jaux[name])) <= 1e-4, name
    for g, jg, name in zip(grads, jgrads, ("student", "logits", "temps")):
        assert _rel(g.numpy(), np.asarray(jg)) <= 1e-3, name


# ---- the CLI on the CPU ----------------------------------------------------

@pytest.mark.parametrize("overrides", [
    ["basd.spectral_backend=jacobi", "basd.max_rank=16"],
    ["basd.spectral_backend=svd"],
    ["basd.relational_impl=composed"],
], ids=["jacobi", "svd", "composed"])
def test_cli_runs_other_backends_on_cpu(tmp_path, overrides):
    main(["experiment=smoke_synthetic", f"run.output_dir={tmp_path}",
          "data.batch_size=32", "+data.limit_train_batches=2",
          "+data.limit_eval_batches=1", *overrides], device="cpu")
    lines = (tmp_path / "smoke_synthetic" / "metrics.jsonl").read_text().splitlines()
    steps = [r for r in map(json.loads, lines) if r["kind"] == "step"]
    assert len(steps) == 2 and all(math.isfinite(r["loss"]) for r in steps)
