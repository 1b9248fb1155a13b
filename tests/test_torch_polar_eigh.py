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
