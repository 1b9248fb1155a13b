"""K7 (Newton-Schulz polar) and K8 (parallel Jacobi eigh) of the port: the
rules and plain mirrors that the CUDA kernels follow, and the eigenvector
rule ``chip_smoke.py`` holds K8 to.

- K8's label formula (``label_pairs`` through ``label_perm``) gives
  ``pair_table``'s pairs with the top slot's index first, every round.
- The plain mirror of K8's two launches (the rounds with their rotation
  log, then the log applied to the identity) gives ``jacobi_eigh_plain``'s
  (w, V) bit for bit; ``chip_smoke.py`` holds the vectors pass alone to it.
- K7's variant rule: the on-chip kernel where X and G fit a block's shared
  memory, the streaming kernel (G in shared memory, X streamed in chunks)
  for the other rows up to 192, the batched kernel (each product one
  launch over every matrix) beyond; the streaming kernel's shared memory
  at each row padding; the batched kernel's workspace.
- ``ns_polar_plain`` against the Pallas kernel in interpret mode at the
  main path's width (192, 384), atol 3e-2 (bf16 intermediates rounded at
  the same points; the products' f32 sums run in another order), and
  within ``chip_smoke.k7_bounds``, the scaled bounds K7 is held to on the
  card, which a plain version one Newton-Schulz step short fails; the
  Pallas kernel within those bounds of the plain version at the on-chip
  and the streaming variants' shapes.
- The eigenvector rule (``chip_smoke.eigvec_rule``: the angle to the true
  eigenvector bounded by the residual over the distance to the other
  eigenvalues) holds for ``jacobi_eigh_plain`` against float64
  ``torch.linalg.eigh`` on principal-angle batches at (48, 96, 96), and
  the old rule (eigenvectors compared where an eigenvalue lies 30 errors
  from its neighbours) fails on seed 2: the fault the new rule repairs.
"""

from __future__ import annotations

import importlib
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from basd_tpu.ops.pallas.ns_polar import ns_polar_hybrid as jax_ns_polar_hybrid
from basd_tpu_torch.kernels import ns_polar

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

# the module (the package re-exports the function under the same name)
je = importlib.import_module("basd_tpu_torch.kernels.jacobi_eigh")


@pytest.fixture
def one_thread():
    """The plain Jacobi's hundreds of rounds are thousands of small ops:
    one intra-op thread is nearly as fast alone and does not thrash when
    the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("n", [2, 4, 6, 8, 96, 192, 256])
def test_label_pairs_reproduce_pair_table(n):
    """Every round, the label formula's pairs are pair_table's, each with
    the top slot's index first."""
    perm = je.label_perm(n)
    assert sorted(perm.tolist()) == list(range(n))
    pairs = perm[je.label_pairs(n)]
    table = je.pair_table(n)
    assert pairs.shape == table.shape
    for r in range(n - 1):
        assert (sorted(map(tuple, pairs[r].tolist()))
                == sorted(map(tuple, table[r].tolist())))


def _sym(rng, bsz, n):
    x = rng.standard_normal((bsz, n, n))
    return torch.from_numpy(((x + x.transpose(0, 2, 1)) / 2).astype(np.float32))


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("n,structure,sweeps", [
    (8, "random", 6), (32, "random", 6), (32, "principal", 6),
    (16, "random", 0), (2, "random", 3)])
def test_two_pass_mirror_matches_plain(n, structure, sweeps):
    """The rounds (w and the rotation log), then the vectors pass, sorted,
    equal jacobi_eigh_plain bit for bit; on CPU tensors the wrappers take
    these mirrors."""
    rng = np.random.default_rng(n)
    if structure == "random":
        a = _sym(rng, 3, n)
    else:
        g = torch.Generator().manual_seed(3)
        a = chip_smoke.principal_angle_grams(torch, "cpu", g, 3, 2 * n, n)
    w, v = je.jacobi_eigh_plain(a, sweeps)
    wr, log = je.jacobi_rounds_plain(a, sweeps)
    assert log.shape == (3, sweeps * (n - 1), n // 2, 2)
    vr = je.jacobi_vectors_plain(log, n)
    ws, vs = je._sorted(wr, vr)
    assert torch.equal(ws, w) and torch.equal(vs, v)
    w2, log2 = je.jacobi_rounds(a, sweeps)
    assert torch.equal(w2, wr) and torch.equal(log2, log)
    assert torch.equal(je.jacobi_vectors(log, n), vr)
    w3, v3 = je.jacobi_eigh(a, sweeps)
    assert torch.equal(w3, w) and torch.equal(v3, v)


def test_jacobi_vectors_rejects_a_foreign_log():
    log = torch.zeros((2, 7, 4, 2))
    with pytest.raises(ValueError):
        je.jacobi_vectors(log, 10)  # 7 rounds is not a whole number of sweeps of 9
    with pytest.raises(ValueError):
        je.jacobi_vectors(torch.zeros((2, 7, 3, 2)), 8)


@pytest.mark.parametrize("n,variant", [
    (8, "smem"), (96, "smem"), (192, "smem"), (240, "smem"),
    (242, "global"), (256, "global")])
def test_rounds_variant(n, variant):
    """A and the round's rotations in shared memory while their n^2 + n
    floats fit a block's 232,448 bytes, else A in a workspace."""
    assert je.rounds_variant(n) == variant


@pytest.mark.parametrize("r,c,variant", [
    (192, 384, "onchip"), (96, 384, "onchip"), (16, 128, "onchip"),
    (8, 128, "onchip"), (128, 512, "onchip"), (384, 768, "batched"),
    (192, 512, "stream"), (256, 256, "batched"), (192, 768, "stream"),
    (192, 2048, "stream"), (192, 640, "stream"), (64, 2048, "stream"),
    (128, 1024, "stream"), (320, 768, "batched"), (512, 1024, "batched"),
    (200, 256, "batched")])
def test_ns_polar_variant(r, c, variant):
    """On chip where the rows pad to at most 192 (three warpgroups) and X
    and G fit one block's shared memory; else the streaming kernel where
    the rows pad to at most 192; else the batched kernel: the DINOv2
    students' (320, 768) and (512, 1024), and every shape the workspace
    kernel took before it."""
    assert ns_polar.ns_polar_variant(r, c) == variant


@pytest.mark.parametrize("r,c,mib", [(320, 768, 1.328125), (512, 1024, 3.0)])
def test_batched_workspace(r, c, mib):
    """The batched kernel's workspace a matrix: X twice (a step's input and
    output), G and H, in bf16: 1.33 MiB at (320, 768), 680 MiB for the
    512 matrices of the ViT-B/14 path's Procrustes batch."""
    assert ns_polar.batched_workspace_elems(r, c) * 2 / 2 ** 20 == mib


@pytest.mark.parametrize("nb,r,c", [(2, 320, 768), (1, 64, 128)])
def test_polar_flops_counts_the_symmetric_products_once(nb, r, c):
    """The bound's operations: the plain version's products as PyTorch's
    flop counter counts them (every product whole), less the half below
    the diagonal of each symmetric one, r (r - 1) / 2 dot products of
    X X^T (7 a call, length c) and of G G^T (5, length r)."""
    from torch.utils.flop_counter import FlopCounterMode

    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (nb, r, c)).astype(np.float32))
    with FlopCounterMode(display=False) as counter:
        ns_polar.ns_polar_plain(x)
    mirrored = nb * r * (r - 1) * (7 * c + 5 * r)
    assert ns_polar.polar_flops(nb, r, c) == counter.get_total_flops() - mirrored


@pytest.mark.parametrize("rp,smem", [(64, 58432), (128, 132176),
                                      (192, 222304)])
def test_ns_polar_stream_smem(rp, smem):
    """G (2 rp^2 B), six chunks of rp x 64 bf16, 1024 B of alignment slack,
    six mbarriers and a float a warp, whatever c: 222,304 of a block's
    232,448 bytes at 192 rows (G 73,728 B, the chunks 147,456 B)."""
    assert ns_polar.stream_smem_bytes(rp) == smem <= 232448


def test_ns_polar_onchip_smem_at_the_main_shape():
    """X (147,456 B) and G (73,728 B) of (192, 384), 1024 B of alignment
    slack and 12 floats of reduction: 222,256 of 232,448 bytes."""
    assert ns_polar.onchip_smem_bytes(192, 384) == 222256


def test_k7_plain_matches_pallas_at_main_width():
    """ns_polar_plain against the Pallas kernel in interpret mode at the
    Procrustes width (8, 192, 384), decaying spectrum: atol 3e-2."""
    rng = np.random.default_rng(12)
    b, r, c = 8, 192, 384
    u = np.linalg.qr(rng.standard_normal((b, r, r)))[0]
    v = np.linalg.qr(rng.standard_normal((b, c, c)))[0][:, :, :r]
    s = np.logspace(0, -2, r)
    m = np.einsum("bik,k,bjk->bij", u, s, v).astype(np.float32)
    ref = np.asarray(jax_ns_polar_hybrid(jnp.asarray(m), tile_b=8,
                                         interpret=True).astype(jnp.float32))
    out = ns_polar.ns_polar_plain(torch.from_numpy(m)).float().numpy()
    np.testing.assert_allclose(out, ref, atol=3e-2)


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("nb,r,c,reduced", [
    (4, 192, 384, False), (4, 192, 768, True), (2, 192, 2048, True),
    (2, 384, 768, False), (2, 64, 2048, True), (2, 128, 1024, True),
    (2, 320, 768, True)])
def test_k7_bounds_admit_rounding_and_fail_a_step_short(nb, r, c, reduced):
    """``chip_smoke.k7_bounds`` at the shapes ``k7_check`` runs (rows 192
    under D_t = 384 / 768 / 2048, (384, 768), the streaming variant's
    narrower row paddings at (64, 2048) and (128, 1024), and the ViT-B/14
    path's (320, 768) on the batched variant): the plain version
    with f32 intermediates, which rounds nowhere the bf16 one does, passes
    against the bf16 plain factor; the controls one quintic step short and
    one cubic step short fail."""
    g = torch.Generator().manual_seed(21)
    mats = chip_smoke.polar_batch(
        torch, lambda *shape: torch.randn(*shape, generator=g), nb, r, c,
        reduced=reduced)
    ref = ns_polar.ns_polar_plain(mats)
    assert chip_smoke.k7_bounds(torch, ns_polar.ns_polar_plain(
        mats, inner_dtype=torch.float32), ref)["ok"]
    for short in (dict(quintic=ns_polar.QUINTIC_SCHEDULE[:-1]),
                  dict(num_cubic=ns_polar.NUM_CUBIC - 1)):
        assert not chip_smoke.k7_bounds(
            torch, ns_polar.ns_polar_plain(mats, **short), ref)["ok"], short


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("nb,r,c", [(4, 192, 384), (2, 192, 768),
                                    (1, 192, 2048), (2, 320, 768)])
def test_k7_bounds_hold_for_the_pallas_kernel(nb, r, c):
    """The JAX package's Pallas kernel (interpret mode), whose products sum
    in another order than the plain version's, within ``k7_bounds`` of it
    at the on-chip variant's (192, 384), the streaming variant's (192,
    768) and (192, 2048) and the batched variant's (320, 768): the plain
    version is the streaming and batched kernels' yardstick on the card."""
    g = torch.Generator().manual_seed(22)
    mats = chip_smoke.polar_batch(
        torch, lambda *shape: torch.randn(*shape, generator=g), nb, r, c,
        reduced=c > 384)
    out = jax_ns_polar_hybrid(jnp.asarray(mats.numpy()), tile_b=nb,
                              interpret=True).astype(jnp.float32)
    bounds = chip_smoke.k7_bounds(torch, torch.from_numpy(np.asarray(out)),
                                  ns_polar.ns_polar_plain(mats))
    assert bounds["ok"], bounds


def _old_rule_min_dot(w, v, wl, vl):
    """The replaced rule: |<v_i, v_ref_i>| over eigenvalues more than 30
    eigenvalue errors from their neighbours."""
    err = (w.double() - wl).abs().max().item()
    gaps = wl.diff(dim=-1)
    inf = torch.full_like(wl[:, :1], math.inf)
    gap = torch.minimum(torch.cat([inf, gaps], -1), torch.cat([gaps, inf], -1))
    return (v.double() * vl).sum(1).abs()[gap > 30 * err].min().item()


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_eigvec_rule_holds_for_plain_jacobi(seed):
    """jacobi_eigh_plain (6 sweeps) against float64 eigh on a seeded
    principal-angle batch at (48, 96, 96): the residual rule covers most
    vectors and holds; on seed 2 the old separation rule fails (min |dot|
    0.998 < 1 - 1e-3) where nothing is wrong."""
    g = torch.Generator().manual_seed(seed)
    a = chip_smoke.principal_angle_grams(torch, "cpu", g, 48, 192, 96)
    w, v = je.jacobi_eigh_plain(a, 6)
    wl, vl = torch.linalg.eigh(a.double())
    rule = chip_smoke.eigvec_rule(torch, a, w, v, wl, vl)
    assert rule["ok"], rule
    assert rule["covered"] > 4000 and rule["tight"] > 3000, rule
    assert rule["min_dot_tight"] >= 1 - 1e-3
    if seed == 2:
        assert _old_rule_min_dot(w, v, wl, vl) < 1 - 1e-3


@pytest.mark.usefixtures("one_thread")
def test_eigvec_rule_rejects_inaccurate_vectors():
    """Eigenvectors off by 1e-2 of noise leave residuals that bound too few
    of them: the rule fails; exact ones pass."""
    g = torch.Generator().manual_seed(0)
    a = chip_smoke.principal_angle_grams(torch, "cpu", g, 4, 64, 32)
    wl, vl = torch.linalg.eigh(a.double())
    assert chip_smoke.eigvec_rule(torch, a, wl.float(), vl.float(), wl, vl)["ok"]
    noisy = vl + 1e-2 * torch.randn(vl.shape, generator=g, dtype=vl.dtype)
    rule = chip_smoke.eigvec_rule(torch, a, wl.float(), noisy.float(), wl, vl)
    assert not rule["ok"], rule


# K8 converged (kernels/converged_eigh.py): its plain version on the
# selector's kinds of matrix, its stopping rule, and the 'xla' route

ce = importlib.import_module("basd_tpu_torch.kernels.converged_eigh")


def _psd_gram(g, bsz, n):
    """Centred Grams of 4n rows with a decaying spectrum (the stacked
    selector batch's kind)."""
    x = torch.randn(bsz, 4 * n, n, generator=g, dtype=torch.float64)
    x = x * torch.logspace(0, -3, n, dtype=torch.float64)
    x = x - x.mean(1, keepdim=True)
    return (x.transpose(1, 2) @ x).float()


def _masked_angle_gram(g, bsz, n):
    """``gm gm^T`` of masked cross-basis matrices of square orthogonal
    bases (the principal-angle batch's kind): a zero block beyond the
    masked rank and an exact cluster at 1, whose pairs include exact ties
    a_pp == a_qq."""
    us = torch.linalg.qr(torch.randn(bsz, n, n, generator=g, dtype=torch.float64))[0]
    ut = torch.linalg.qr(us + 0.3 * torch.linalg.qr(
        torch.randn(bsz, n, n, generator=g, dtype=torch.float64))[0])[0]
    k = (n * 7) // 8
    mask = (torch.arange(n) < k).double()
    gm = mask[:, None] * (us.transpose(1, 2) @ ut) * mask[None, :]
    return (gm @ gm.transpose(1, 2)).float()


def _degenerate(g, bsz, n):
    """An exact degenerate cluster: half the spectrum at 1."""
    q = torch.linalg.qr(torch.randn(bsz, n, n, generator=g, dtype=torch.float64))[0]
    w = torch.cat([torch.ones(n // 2, dtype=torch.float64),
                   torch.linspace(0.1, 0.9, n - n // 2, dtype=torch.float64)])
    return ((q * w) @ q.transpose(1, 2)).float()


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("kind,n", [
    ("gram", 4), ("gram", 17), ("gram", 48), ("angle", 16), ("angle", 33),
    ("angle", 64), ("degenerate", 9), ("degenerate", 40)])
def test_converged_plain_against_eigh(kind, n):
    """The plain version's eigenvalues within 4e-6 ||A|| of float64 eigh's
    (and of ``torch.linalg.eigh``'s f32 ones), V orthogonal to 4e-6 and
    ||A V - V diag(w)|| within 4e-6 ||A||, even and odd n, each matrix
    converged before the cap."""
    make = {"gram": _psd_gram, "angle": _masked_angle_gram,
            "degenerate": _degenerate}[kind]
    a = make(torch.Generator().manual_seed(n), 3, n)
    w, v, sweeps = ce.converged_eigh_plain(a)
    assert w.shape == (3, n) and v.shape == (3, n, n)
    a64 = a.double()
    norm = torch.linalg.matrix_norm(a64, ord=2)[:, None]
    lam = torch.linalg.eigvalsh(a64)
    assert ((w.double() - lam).abs() / norm).max() <= 4e-6
    assert ((w - torch.linalg.eigvalsh(a)).double().abs() / norm).max() <= 8e-6
    eye = torch.eye(n, dtype=torch.float64)
    assert (v.double().transpose(1, 2) @ v.double() - eye).abs().max() <= 4e-6
    res = torch.linalg.matrix_norm(a64 @ v.double() - v.double() * w.double()[:, None])
    assert (res / torch.linalg.matrix_norm(a64)).max() <= 4e-6
    assert bool((w[:, 1:] >= w[:, :-1]).all())
    assert bool((sweeps > 1).all()) and bool((sweeps < ce.MAX_SWEEPS).all())


@pytest.mark.parametrize("n", [1, 2, 5, 8])
def test_converged_diagonal_input_stops_after_one_sweep(n):
    """A diagonal matrix has no pair over the bar: one sweep, no rotation,
    its diagonal sorted and the permutation as V; asymmetric input is
    symmetrised first."""
    d = torch.tensor([3.0, -1.0, 2.0, 0.5, 7.0, -4.0, 1.5, 0.0])[:n]
    a = torch.diag_embed(d)[None].clone()
    if n > 1:
        a[0, 0, 1], a[0, 1, 0] = 1e-3, -1e-3  # (a + a^T) / 2 is diagonal
    w, v, sweeps = ce.converged_eigh_plain(a)
    assert sweeps.tolist() == [1]
    order = torch.argsort(d, stable=True)
    assert torch.equal(w[0], d[order])
    assert torch.equal(v[0], torch.eye(n)[:, order])


def test_converged_exact_tie_takes_the_45_degree_rotation():
    """a_pp == a_qq exactly: sign(0) = 1 rotates by 45 degrees (K8's
    sign(0) = 0 would leave the pair, and the diagonal block's update would
    then zero a_pq without rotating it)."""
    a = torch.tensor([[[1.0, 0.5], [0.5, 1.0]]])
    w, v, sweeps = ce.converged_eigh_plain(a)
    assert torch.allclose(w[0], torch.tensor([0.5, 1.5]), atol=1e-7)
    assert torch.allclose(v[0].abs(), torch.full((2, 2), 0.5 ** 0.5), atol=1e-7)
    assert sweeps.tolist() == [2]


def test_converged_zero_rows_are_their_own_eigenpairs():
    """Zero rows (anywhere, a different count a matrix) take (0, e_i); the
    rest is the solve of the other rows alone, in their order."""
    g = torch.Generator().manual_seed(4)
    a = _psd_gram(g, 3, 12)
    dead = [[1, 5, 6], [0, 11], []]
    for b, rows in enumerate(dead):
        a[b, rows, :] = 0.0
        a[b, :, rows] = 0.0
    w, v, sweeps = ce.converged_eigh_plain(a)
    for b, rows in enumerate(dead):
        keep = [i for i in range(12) if i not in rows]
        wk, vk, sk = ce.converged_eigh_plain(a[b][keep][:, keep][None])
        assert sweeps[b] == sk[0]
        assert torch.equal(w[b][w[b] != 0], wk[0][wk[0] != 0])
        for i in rows:
            col = torch.nonzero((v[b] == torch.eye(12)[:, i:i + 1]).all(0))
            assert len(col) == 1 and w[b, col[0, 0]] == 0.0
    res = torch.linalg.matrix_norm(a.double() @ v.double() - v.double() * w.double()[:, None])
    assert (res / torch.linalg.matrix_norm(a.double())).max() <= 4e-6


def test_converged_sweep_cap_holds():
    """The cap stops a matrix that has not converged, and a matrix that
    converges takes the sweeps it needs, fewer than the cap."""
    a = _psd_gram(torch.Generator().manual_seed(1), 2, 24)
    _, _, capped = ce.converged_eigh_plain(a, max_sweeps=2)
    assert capped.tolist() == [2, 2]
    _, _, free = ce.converged_eigh_plain(a)
    assert bool((free > 2).all()) and bool((free < ce.MAX_SWEEPS).all())


def test_eigh_route():
    """'xla' takes K8 converged on an f32 CUDA tensor up to n = 512 and
    ``torch.linalg.eigh`` on the CPU, in f64 and beyond n = 512 (the
    calibration's 768- and 1024-wide teacher covariances); 'jacobi' stays
    K8."""
    from basd_tpu_torch.ops import linalg

    class _Cuda:
        """What the route reads of a CUDA tensor."""

        def __init__(self, n, dtype=torch.float32):
            self.device, self.dtype, self.shape = torch.device("cuda"), dtype, (2, n, n)

    assert linalg._eigh_route(_Cuda(320), "xla") == "converged"
    assert linalg._eigh_route(_Cuda(ce.MAX_N), "xla") == "converged"
    assert ce.MAX_N == 512
    for n in (513, 768, 1024):
        assert linalg._eigh_route(_Cuda(n), "xla") == "xla"
    assert linalg._eigh_route(_Cuda(320, torch.float64), "xla") == "xla"
    assert linalg._eigh_route(_Cuda(320), "jacobi") == "jacobi"
    assert linalg._eigh_route(torch.zeros((2, 4, 4)), "xla") == "xla"


def test_xla_route_on_cpu_calls_torch_eigh_and_counters_count(monkeypatch):
    """On a CPU tensor the 'xla' route is ``torch.linalg.eigh`` and launches
    nothing; the tracer counts the calls and matrices under the route taken
    (``eigh.*.converged`` where K8 converged takes them, ``eigh.*.xla``
    then 0)."""
    from basd_tpu_torch.ops import linalg
    from basd_tpu_torch.utils import trace

    a = _psd_gram(torch.Generator().manual_seed(2), 3, 8)
    calls = []
    real = torch.linalg.eigh
    monkeypatch.setattr(torch.linalg, "eigh",
                        lambda x, *args, **kw: calls.append(x.shape) or real(x, *args, **kw))
    launches = ce.converged_eigh.launches
    trace.reset()
    trace.enable()
    try:
        w, v = linalg._eigh_impl(a, "xla")
        assert calls == [a.shape] and ce.converged_eigh.launches == launches
        assert torch.equal(w, real(a)[0])
        # the route the card takes, on the plain version
        monkeypatch.setattr(linalg, "_eigh_route", lambda x, impl: "converged")
        w2, v2 = linalg._eigh_impl(a.reshape(1, 3, 8, 8), "xla")
        counters = trace.summary()["counters"]
    finally:
        trace.disable()
        trace.reset()
    assert len(calls) == 1
    wp, vp, _ = ce.converged_eigh_plain(a)
    assert torch.equal(w2[0], wp) and torch.equal(v2[0], vp)
    assert counters["eigh.calls.converged"] == 1
    assert counters["eigh.matrices.converged"] == 3
    assert counters["eigh.calls.xla"] == 1 and counters["eigh.matrices.xla"] == 3
