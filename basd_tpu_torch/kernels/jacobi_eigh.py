"""K8: batched symmetric eigensolver, cyclic parallel (Brent-Luk) Jacobi.

Replaces ``basd_tpu/ops/pallas/jacobi_eigh.py:jacobi_eigh``
(``_jacobi_kernel``): for each symmetric (n, n) f32 matrix, n even,
``sweeps`` sweeps of n - 1 rounds, each round rotating n/2 disjoint index
pairs at once, eigenvectors accumulated as ``V <- V J``; eigenvalues sorted
ascending (stable) outside the kernel, with the columns of V permuted to
match.

The TPU kernel keeps the matrix in slot space: pairs are fixed as slots
(j, j + n/2) and each round ends with a constant music-chairs column
permutation, all as products against constant matrices. The slot
permutation has a single cycle of length n - 1 over slots 1..n-1, so after
a whole sweep slot space is index space again. Here the matrix stays in
index space and each round rotates the pairs that the slots hold in that
round: ``pair_table`` replays the slot rule, top slot first.

One rotation per pair, from the top slot p: ``tau = (a_qq - a_pp) /
(2 a_pq)``, ``t = sign(tau) / (|tau| + sqrt(1 + tau^2))``, ``c = rsqrt(1 +
t^2)``, ``s = t c``, none where ``|a_pq| <= 1e-30``, and the bottom slot
q takes (c, -s): the Givens rotation ``J = [[c, s], [-s, c]]`` (rows and
columns p, q). The TPU kernel's design states exactly this (tau is odd
under p <-> q), but it evaluates the formula again for the bottom slot
from ``a_qp``. A is symmetric only to the last bit after the first round,
so where a pair's diagonal entries (nearly) coincide, as in a cluster of
principal cosines at 1, the two slots take angles that differ by O(1) and
its J stops being orthogonal: its eigenvalues of such a cluster drift by
~1e-3 after 6 sweeps and further with more (tests/test_torch_backends.py:
``test_jacobi_degenerate_cluster``). K8 keeps J orthogonal to rounding.

For a CUDA tensor two launches of ``csrc/jacobi_eigh.cu`` run: the rounds
(``jacobi_rounds``, ``basd_jacobi_rounds``: A in label order, see
``label_pairs``, in one block per matrix, writing each round's (c, s) to a
rotation log; its variant, ``rounds_variant``, is picked from n before the
launch) and the vectors pass (``jacobi_vectors``, ``basd_jacobi_vectors``:
the log applied to V's rows, spread over the card; launched to run beside
the rounds, following the log as a progress count publishes it). ``jacobi_eigh_plain``
is the same rounds in plain PyTorch, batched over the matrices, taken for a
CPU tensor; ``jacobi_rounds_plain`` and ``jacobi_vectors_plain`` mirror the
two launches and give the same bits.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from basd_tpu_torch.kernels import _build

# no rotation where |a_pq| <= this (the TPU kernel's guard)
_EPS = 1e-30
# a block's dynamic shared memory on sm_90
_SMEM_BYTES = 232448
# the rounds kernel's variants, in the order of csrc/jacobi_eigh.cu's
# JacobiRounds: A in shared memory, A in a device-memory workspace
ROUNDS_VARIANTS = ("smem", "global")
# the widest n the rounds kernel takes (16 rotations a lane)
_MAX_N = 1024


@functools.lru_cache(maxsize=None)
def pair_table(n: int) -> np.ndarray:
    """(n - 1, n/2, 2) int32: round r's pairs (p, q), p in the top slot.

    Slot j < n/2 pairs with slot j + n/2; after each round slot s takes
    what slot sigma(s) held, sigma(0) = 0, sigma(1) = n/2,
    sigma(d) = d - 1 (2 <= d < n/2), sigma(d) = d + 1 (n/2 <= d <= n-2),
    sigma(n-1) = n/2 - 1 (``basd_tpu/ops/pallas/jacobi_eigh.py:108-117``).
    """
    if n % 2 or n < 2:
        raise ValueError(f"jacobi_eigh: n must be even and >= 2, got {n}")
    m = n // 2
    if n == 2:
        return np.asarray([[[0, 1]]], np.int32)
    sigma = np.empty(n, np.int64)
    sigma[0], sigma[1], sigma[n - 1] = 0, m, m - 1
    sigma[2:m] = np.arange(1, m - 1)
    sigma[m:n - 1] = np.arange(m + 1, n)
    slots = np.arange(n)  # slots[s] = the index slot s holds
    table = np.empty((n - 1, m, 2), np.int32)
    for r in range(n - 1):
        table[r, :, 0] = slots[:m]
        table[r, :, 1] = slots[m:]
        slots = slots[sigma]
    return table


@functools.lru_cache(maxsize=None)
def label_perm(n: int) -> np.ndarray:
    """(n,) int64: the index that label l stands for. Label 0 is index 0;
    labels 1 ... n-1 are the indices slots 1, 2, ..., m-1, n-1, n-2, ..., m
    hold at round 0, the order of the slot permutation's cycle."""
    m = n // 2
    return np.asarray([0, *range(1, m), *range(n - 1, m - 1, -1)], np.int64)


@functools.lru_cache(maxsize=None)
def label_pairs(n: int) -> np.ndarray:
    """(n - 1, n/2, 2) int64: round r's pairs (p, q) in labels, pair t
    = (0, 1 + u0) for t = 0, else (1 + (u0 + t) mod (n - 1),
    1 + (u0 - t) mod (n - 1)), u0 = n - 2 - r; p is the top slot's
    (``csrc/jacobi_eigh.cu:round_pair``). Through ``label_perm`` these are
    ``pair_table``'s pairs and orientations, in another order."""
    pair_table(n)  # raises for odd n
    m, L = n // 2, n - 1
    r = np.arange(L)[:, None]
    t = np.arange(m)[None, :]
    u0 = n - 2 - r
    p = np.where(t == 0, 0, 1 + (u0 + t) % L)
    q = 1 + (u0 - t) % L
    return np.stack(np.broadcast_arrays(p, q), -1)


def rounds_variant(n: int) -> str:
    """The rounds kernel's variant for n (``csrc/jacobi_eigh.cu``:
    ``rounds_smem_bytes``): ``smem`` where A and the round's rotations fit
    a block's shared memory (n <= 240), else ``global``."""
    return "smem" if 4 * n + 4 * n * n <= _SMEM_BYTES else "global"


def _rotation(app, aqq, apq):
    """(c, s) of a pair: tau = (a_qq - a_pp) / (2 a_pq),
    t = sign(tau) / (|tau| + sqrt(1 + tau^2)), none where |a_pq| <= eps."""
    ok = apq.abs() > _EPS
    tau = (aqq - app) / (2.0 * torch.where(ok, apq, torch.ones_like(apq)))
    t = torch.sign(tau) / (tau.abs() + torch.sqrt(1.0 + tau * tau))
    t = torch.where(ok, t, torch.zeros_like(t))
    c = torch.rsqrt(1.0 + t * t)
    return c, t * c


def _rotate_columns(x, p, q, c, s) -> None:
    """x <- x J in place: columns p, q of (B, n, n) x by (c, s)."""
    xp, xq = x[:, :, p], x[:, :, q]
    x[:, :, p] = c[:, None, :] * xp - s[:, None, :] * xq
    x[:, :, q] = s[:, None, :] * xp + c[:, None, :] * xq


def _rotate_rows(a, p, q, c, s) -> None:
    """a <- J^T a in place."""
    ap, aq = a[:, p, :], a[:, q, :]
    a[:, p, :] = c[:, :, None] * ap - s[:, :, None] * aq
    a[:, q, :] = s[:, :, None] * ap + c[:, :, None] * aq


def _eye(bsz: int, n: int, device) -> torch.Tensor:
    return torch.eye(n, dtype=torch.float32, device=device).expand(bsz, n, n).clone()


def _rounds_plain(a: torch.Tensor, sweeps: int):
    """Unsorted (w, V) of (B, n, n) f32 after ``sweeps`` sweeps."""
    bsz, n, _ = a.shape
    a = a.clone()
    v = _eye(bsz, n, a.device)
    table = torch.from_numpy(pair_table(n)).long().to(a.device)
    for it in range(sweeps * (n - 1)):
        p, q = table[it % (n - 1)].unbind(-1)
        c, s = _rotation(a[:, p, p], a[:, q, q], a[:, p, q])
        # columns: A <- A J, V <- V J; then rows: A <- J^T A
        _rotate_columns(a, p, q, c, s)
        _rotate_columns(v, p, q, c, s)
        _rotate_rows(a, p, q, c, s)
    return torch.diagonal(a, dim1=-2, dim2=-1).clone(), v


def jacobi_rounds_plain(a: torch.Tensor, sweeps: int):
    """The rounds launch in plain PyTorch: (w unsorted (B, n), log (B,
    sweeps (n - 1), n/2, 2)), the log holding each round's (c, s) in
    ``label_pairs`` order."""
    _check(a)
    bsz, n, _ = a.shape
    a = a.float().clone()
    idx = torch.from_numpy(label_perm(n)[label_pairs(n)]).to(a.device)
    log = []
    for it in range(sweeps * (n - 1)):
        p, q = idx[it % (n - 1)].unbind(-1)
        c, s = _rotation(a[:, p, p], a[:, q, q], a[:, p, q])
        log.append(torch.stack([c, s], -1))
        _rotate_columns(a, p, q, c, s)
        _rotate_rows(a, p, q, c, s)
    log = (torch.stack(log, 1) if log
           else a.new_empty((bsz, 0, n // 2, 2)))
    return torch.diagonal(a, dim1=-2, dim2=-1).clone(), log


def jacobi_vectors_plain(log: torch.Tensor, n: int) -> torch.Tensor:
    """The vectors pass in plain PyTorch: V (B, n, n) = I J_1 ... J_T from
    the rotation log (unsorted columns)."""
    v = _eye(log.shape[0], n, log.device)
    idx = torch.from_numpy(label_perm(n)[label_pairs(n)]).to(log.device)
    for it in range(log.shape[1]):
        p, q = idx[it % (n - 1)].unbind(-1)
        _rotate_columns(v, p, q, log[:, it, :, 0], log[:, it, :, 1])
    return v


def _sorted(w: torch.Tensor, v: torch.Tensor):
    order = torch.argsort(w, dim=-1, stable=True)
    return (torch.gather(w, -1, order),
            torch.gather(v, -1, order[:, None, :].expand_as(v)))


def _check(a: torch.Tensor) -> None:
    if a.dim() != 3 or a.shape[1] != a.shape[2]:
        raise ValueError(f"jacobi_eigh: expected (B, n, n), got {tuple(a.shape)}")
    pair_table(a.shape[1])  # raises for odd n


def jacobi_eigh_plain(a: torch.Tensor, sweeps: int = 10):
    """(w ascending (B, n), V (B, n, n)) of symmetric (B, n, n) f32, n
    even: the kernel's rounds in plain PyTorch."""
    _check(a)
    return _sorted(*_rounds_plain(a.float(), sweeps))


def _check_cuda(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    if t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous float32 tensor")


def jacobi_rounds(a: torch.Tensor, sweeps: int, progress=None):
    """The rounds: (w unsorted (B, n), rotation log (B, sweeps (n - 1),
    n/2, 2)) of symmetric (B, n, n) f32, n even. ``progress`` (B) int32
    zeros, on the card, receives the rounds whose log is written (for a
    vectors pass launched right after; fresh zeros if None)."""
    _check(a)
    if a.device.type == "cpu":
        return jacobi_rounds_plain(a, sweeps)
    _check_cuda("jacobi_rounds", a)
    bsz, n, _ = a.shape
    if n > _MAX_N:
        raise ValueError(f"jacobi_rounds: n must be <= {_MAX_N}, got {n}")
    variant = rounds_variant(n)
    w = torch.empty((bsz, n), dtype=torch.float32, device=a.device)
    log = torch.empty((bsz, sweeps * (n - 1), n // 2, 2), dtype=torch.float32,
                      device=a.device)
    ws = torch.empty_like(a) if variant == "global" else None
    if progress is None:
        progress = _progress(bsz, a.device)
    if bsz:
        _build.call("basd_jacobi_rounds", a.data_ptr(), w.data_ptr(),
                    log.data_ptr(), 0 if ws is None else ws.data_ptr(),
                    progress.data_ptr(), bsz, n, sweeps,
                    ROUNDS_VARIANTS.index(variant), _build.stream_ptr(a.device))
        jacobi_rounds.launches += 1
        jacobi_rounds.variants[variant] += 1
    return w, log


jacobi_rounds.launches = 0
# launches by variant
jacobi_rounds.variants = dict.fromkeys(ROUNDS_VARIANTS, 0)


def _progress(bsz: int, device) -> torch.Tensor:
    return torch.zeros((bsz,), dtype=torch.int32, device=device)


def jacobi_vectors(log: torch.Tensor, n: int, progress=None,
                   out=None) -> torch.Tensor:
    """The vectors pass: V (B, n, n), unsorted columns, from the rounds'
    log, into ``out`` if given. With the rounds' ``progress``, the rounds
    having been launched just before on the same stream, it starts beside
    them and follows the log as they write it; without, the log must be
    whole. A pass beside the rounds must write into memory allocated before
    the rounds' launch: the allocator may hand the pass memory the rounds
    freed after their launch (the workspace) while they still use it."""
    if log.dim() != 4 or log.shape[2:] != (n // 2, 2) or log.shape[1] % (n - 1):
        raise ValueError(f"jacobi_vectors: log {tuple(log.shape)} is not a "
                         f"rotation log of n = {n}")
    if log.device.type == "cpu":
        return jacobi_vectors_plain(log, n)
    _check_cuda("jacobi_vectors", log)
    bsz = log.shape[0]
    v = (torch.empty((bsz, n, n), dtype=torch.float32, device=log.device)
         if out is None else out)
    if bsz:
        _build.call("basd_jacobi_vectors", log.data_ptr(), v.data_ptr(),
                    0 if progress is None else progress.data_ptr(), bsz, n,
                    log.shape[1], _build.stream_ptr(log.device))
        jacobi_vectors.launches += 1
    return v


jacobi_vectors.launches = 0


def jacobi_eigh(a: torch.Tensor, sweeps: int = 10):
    """Batched symmetric eigh by parallel Jacobi: ``(w, v)``, ``w`` (B, n)
    ascending, ``v[:, :, i]`` the eigenvector of ``w[:, i]`` (up to sign).
    ``a`` (B, n, n) symmetric float32, n even. On the card: the rounds,
    and beside them the vectors pass, which follows their log."""
    _check(a)
    if a.device.type == "cpu":
        return jacobi_eigh_plain(a, sweeps)
    _check_cuda("jacobi_eigh", a)
    bsz, n, _ = a.shape
    progress = _progress(bsz, a.device)
    v = torch.empty((bsz, n, n), dtype=torch.float32, device=a.device)
    w, log = jacobi_rounds(a, sweeps, progress)
    jacobi_vectors(log, n, progress, out=v)
    if a.shape[0]:
        jacobi_eigh.launches += 1
    return _sorted(w, v)


jacobi_eigh.launches = 0
