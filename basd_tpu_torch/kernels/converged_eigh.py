"""K8 converged: batched symmetric eigh by cyclic parallel Jacobi, run on
the card until each matrix has converged.

K8's rotations (``kernels/jacobi_eigh.py``: the Brent-Luk order of
``pair_table``, one rotation per pair from the top slot, the 1e-30 guard;
sign(0) = 1, ``_rotations`` says why), swept until a whole sweep finds no
pair with ``|a_pq| > TOL sqrt(|a_pp a_qq|)``, at most ``MAX_SWEEPS``
sweeps. A pair at or under that bar is not
rotated; a rotated pair's diagonal block takes ``a_pp - t a_pq``, ``a_qq +
t a_pq`` and exact zeros; V accumulates ``V <- V J`` in Rutishauser's form
``x - s (y + tau x)``, ``tau = s / (1 + c)``, which keeps V orthogonal to f32
accuracy where ``c x - s y`` drifts (~1e-5 at n = 64 after five sweeps).
The input is symmetrised as ``(A + A^T) / 2`` (what ``torch.linalg.eigh``'s
route in ``ops/linalg.py`` does). Rows that are zero (the principal-angle
Grams' beyond their masked rank) are eigenpairs (0, e_i) as they stand: the
rotations run on the other rows alone, in their order, an odd count padded
by one zero row and column whose isolated eigenpair is dropped. The outputs
are ``torch.linalg.eigh``'s: eigenvalues ascending (stable over the index),
V's columns matching.

For a CUDA tensor ONE launch of ``csrc/converged_eigh.cu`` does all of it,
sort and column permutation included: a thread-block cluster per matrix
holds A and V in the distributed shared memory of its blocks, tests
convergence on the card after every sweep and stops there, so no value
crosses to the host and the call is legal inside a CUDA-graph capture. The
cluster size comes from (batch, n) (``plan``). n is at most ``MAX_N``.
``converged_eigh_plain`` is
the same rotations, order and stopping rule in plain PyTorch, batched over
the matrices (a converged matrix takes identity rotations from then on),
taken for a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

from basd_tpu_torch.kernels import _build
from basd_tpu_torch.kernels.jacobi_eigh import (
    _EPS,
    _check_cuda,
    _eye,
    _rotate_columns,
    _rotate_rows,
    pair_table,
)

# A pair is converged when |a_pq| <= TOL sqrt(|a_pp a_qq|): 2^-21, eight
# units of f32 roundoff (2^-24). After a rotation of a pair whose diagonal
# entries (nearly) coincide, as in a cluster of principal cosines at 1, the
# rounding of the neighbouring rows' updates leaves a_pq at a few units of
# a_pp; a bar at one unit would keep such pairs rotating to the sweep cap,
# one much above it would stop short of f32 accuracy. The test is relative
# (Demmel and Veselic 1992): it resolves the small eigenvalues of a graded
# PSD Gram too. Mirrored in csrc/converged_eigh.cu.
TOL = 2.0 ** -21
# the cap on sweeps (cyclic Jacobi converges quadratically: ~10 sweeps at
# n = 320 in f32)
MAX_SWEEPS = 30
# the widest n the kernel takes: where cuSOLVER's f32 eigh stops using
# Jacobi (syevj) for divide and conquer (syevd), ~10x more accurate than f32
# Jacobi and faster than it beyond a block cluster's shared memory; the
# 'xla' route (ops/linalg.py) leaves wider matrices to torch.linalg.eigh
MAX_N = 512


def _check(a: torch.Tensor) -> None:
    if a.dim() != 3 or a.shape[1] != a.shape[2]:
        raise ValueError(f"converged_eigh: expected (B, n, n), got {tuple(a.shape)}")
    if not 1 <= a.shape[1] <= MAX_N:
        raise ValueError(f"converged_eigh: n must be in [1, {MAX_N}], got {a.shape[1]}")


def _exceeds(app, aqq, apq):
    """Pairs over the convergence bar (the kernel's test, same order of
    operations)."""
    return apq.abs() > TOL * (app.abs().sqrt() * aqq.abs().sqrt())


def _rotations(app, aqq, apq, active):
    """(c, s, tau, t, over, ok) of a round's pairs: K8's rotation (t =
    sign(theta) / (|theta| + sqrt(1 + theta^2)), theta = (a_qq - a_pp) / (2
    a_pq), none where |a_pq| <= 1e-30) where the pair is over the bar and
    its matrix still active (``ok``), else the identity. Here sign(0) = 1:
    where a_pp == a_qq exactly (a cluster of principal cosines at 1 gives
    such pairs) the rotation is the 45-degree one that zeroes a_pq, not
    none, since the diagonal block's update sets a_pq to zero."""
    over = _exceeds(app, aqq, apq)
    ok = over & active[:, None]
    nz = apq.abs() > _EPS
    th = (aqq - app) / (2.0 * torch.where(nz, apq, torch.ones_like(apq)))
    sign = torch.where(th >= 0, 1.0, -1.0)
    t = sign / (th.abs() + torch.sqrt(1.0 + th * th))
    t = torch.where(ok & nz, t, torch.zeros_like(t))
    c = torch.rsqrt(1.0 + t * t)
    s = t * c
    return c, s, s / (1.0 + c), t, over, ok


def _solve_plain(a: torch.Tensor, max_sweeps: int):
    """Unsorted (diagonal (B, n), V (B, n, n), sweeps (B,)) of symmetric
    (B, n, n) f32 by the kernel's rounds, n padded to even."""
    bsz, n, _ = a.shape
    npad = max(2, n + n % 2)
    if npad != n:
        a = torch.nn.functional.pad(a, (0, npad - n, 0, npad - n))
    a = a.clone()
    v = _eye(bsz, npad, a.device)
    table = torch.from_numpy(pair_table(npad)).long().to(a.device)
    rows = torch.arange(bsz, device=a.device)[:, None]
    active = torch.ones(bsz, dtype=torch.bool, device=a.device)
    sweeps = torch.zeros(bsz, dtype=torch.int32, device=a.device)
    for _ in range(max_sweeps):
        over_any = torch.zeros_like(active)
        for r in range(npad - 1):
            p, q = table[r].unbind(-1)
            app, aqq, apq = a[:, p, p], a[:, q, q], a[:, p, q]
            c, s, tau, t, over, ok = _rotations(app, aqq, apq, active)
            over_any |= over.any(-1)
            _rotate_columns(a, p, q, c, s)
            _rotate_rows(a, p, q, c, s)
            # the pairs' own blocks
            a[rows, p, p] = torch.where(ok, app - t * apq, app)
            a[rows, q, q] = torch.where(ok, aqq + t * apq, aqq)
            zero = torch.zeros_like(apq)
            a[rows, p, q] = torch.where(ok, zero, apq)
            a[rows, q, p] = torch.where(ok, zero, a[rows, q, p])
            # V <- V J in Rutishauser's form
            vp, vq = v[:, :, p], v[:, :, q]
            s_, tau_ = s[:, None, :], tau[:, None, :]
            v[:, :, p] = vp - s_ * (vq + tau_ * vp)
            v[:, :, q] = vq + s_ * (vp - tau_ * vq)
        sweeps += active.int()
        active &= over_any
        if not bool(active.any()):
            break
    return torch.diagonal(a, dim1=-2, dim2=-1)[:, :n], v[:, :n, :n], sweeps


def converged_eigh_plain(a: torch.Tensor, max_sweeps: int = MAX_SWEEPS):
    """``(w ascending (B, n), V (B, n, n), sweeps (B,) int32)`` of (B, n, n)
    f32 by the kernel's rotations and stopping rule in plain PyTorch. As the
    kernel, it solves each matrix on its rows that hold a nonzero entry (in
    their order) and gives each zero row its eigenpair (0, e_i); the
    matrices with the same count of such rows go together."""
    _check(a)
    bsz, n, _ = a.shape
    a = (a.float() + a.float().transpose(1, 2)) / 2.0
    live = (a != 0).any(-1)
    counts = live.sum(-1)
    w = torch.zeros((bsz, n), dtype=torch.float32, device=a.device)
    v = torch.zeros((bsz, n, n), dtype=torch.float32, device=a.device)
    sweeps = torch.ones((bsz,), dtype=torch.int32, device=a.device)
    for k in counts.unique().tolist():
        sel = torch.nonzero(counts == k).squeeze(1)
        dead = torch.nonzero(~live[sel])
        v[sel[dead[:, 0]], dead[:, 1], dead[:, 1]] = 1.0
        if not k:
            continue
        idx = torch.nonzero(live[sel])[:, 1].view(len(sel), k)
        sub = torch.gather(torch.gather(a[sel], 1, idx[:, :, None].expand(-1, -1, n)),
                           2, idx[:, None, :].expand(-1, k, -1))
        ws, vs, sweeps[sel] = _solve_plain(sub, max_sweeps)
        w[sel[:, None], idx] = ws
        v[sel[:, None, None], idx[:, :, None], idx[:, None, :]] = vs
    order = torch.argsort(w, dim=-1, stable=True)
    return (torch.gather(w, -1, order),
            torch.gather(v, -1, order[:, None, :].expand_as(v)), sweeps)


# the entries of csrc/converged_eigh.cu:basd_ceigh_plan's output
PLAN_KEYS = ("cluster", "smem_bytes", "active_clusters")


def plan(batch: int, n: int, cluster: int = 0, device=None) -> dict:
    """The kernel's plan for a (batch, n, n) call on the card (cached by the
    library): the cluster size (``cluster`` if not 0, else the kernel's
    choice from batch and n), a block's shared memory and the clusters the
    card holds at once (0 where a forced size does not fit)."""
    out = (ctypes.c_longlong * len(PLAN_KEYS))()
    with torch.cuda.device(torch.device("cuda" if device is None else device)):
        _build.call("basd_ceigh_plan", batch, n, cluster, ctypes.addressof(out))
    return dict(zip(PLAN_KEYS, map(int, out)))


def converged_eigh(a: torch.Tensor):
    """``(w ascending (B, n), V (B, n, n), sweeps (B,) int32)`` of symmetric
    (B, n, n) float32, n <= ``MAX_N``, V's column i the eigenvector of
    w[:, i] (up to sign). On the card: one launch; on the CPU:
    ``converged_eigh_plain``."""
    return _converged_eigh(a, 0)


def _converged_eigh(a: torch.Tensor, cluster: int):
    """``converged_eigh`` at a forced cluster size (0: the plan's), which
    ``tune.py``'s sweep over cluster sizes takes."""
    _check(a)
    if a.device.type == "cpu":
        return converged_eigh_plain(a)
    _check_cuda("converged_eigh", a)
    bsz, n, _ = a.shape
    w = torch.empty((bsz, n), dtype=torch.float32, device=a.device)
    v = torch.empty((bsz, n, n), dtype=torch.float32, device=a.device)
    sweeps = torch.empty((bsz,), dtype=torch.int32, device=a.device)
    if bsz:
        _build.call("basd_ceigh", a.data_ptr(), w.data_ptr(), v.data_ptr(),
                    sweeps.data_ptr(), bsz, n, cluster, _build.stream_ptr(a.device))
        converged_eigh.launches += 1
    return w, v, sweeps


converged_eigh.launches = 0
