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

The CUDA kernel (``csrc/jacobi_eigh.cu``, ``basd_jacobi_eigh``) runs for a
CUDA tensor; ``jacobi_eigh_plain`` is the same rounds in plain PyTorch,
batched over the matrices, taken for a CPU tensor.
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


def _rotation(app, aqq, apq):
    """(c, s) of a pair: tau = (a_qq - a_pp) / (2 a_pq),
    t = sign(tau) / (|tau| + sqrt(1 + tau^2)), none where |a_pq| <= eps."""
    ok = apq.abs() > _EPS
    tau = (aqq - app) / (2.0 * torch.where(ok, apq, torch.ones_like(apq)))
    t = torch.sign(tau) / (tau.abs() + torch.sqrt(1.0 + tau * tau))
    t = torch.where(ok, t, torch.zeros_like(t))
    c = torch.rsqrt(1.0 + t * t)
    return c, t * c


def _rounds_plain(a: torch.Tensor, sweeps: int):
    """Unsorted (w, V) of (B, n, n) f32 after ``sweeps`` sweeps."""
    bsz, n, _ = a.shape
    a = a.clone()
    v = torch.eye(n, dtype=a.dtype, device=a.device).expand(bsz, n, n).clone()
    table = torch.from_numpy(pair_table(n)).long().to(a.device)
    for it in range(sweeps * (n - 1)):
        p, q = table[it % (n - 1)].unbind(-1)
        c, s = _rotation(a[:, p, p], a[:, q, q], a[:, p, q])
        # columns: A <- A J, V <- V J
        for x in (a, v):
            xp, xq = x[:, :, p], x[:, :, q]
            x[:, :, p] = c[:, None, :] * xp - s[:, None, :] * xq
            x[:, :, q] = s[:, None, :] * xp + c[:, None, :] * xq
        # rows: A <- J^T A
        ap, aq = a[:, p, :], a[:, q, :]
        a[:, p, :] = c[:, :, None] * ap - s[:, :, None] * aq
        a[:, q, :] = s[:, :, None] * ap + c[:, :, None] * aq
    return torch.diagonal(a, dim1=-2, dim2=-1).clone(), v


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


def jacobi_eigh(a: torch.Tensor, sweeps: int = 10):
    """Batched symmetric eigh by parallel Jacobi: ``(w, v)``, ``w`` (B, n)
    ascending, ``v[:, :, i]`` the eigenvector of ``w[:, i]`` (up to sign).
    ``a`` (B, n, n) symmetric float32, n even."""
    _check(a)
    if a.device.type == "cpu":
        return jacobi_eigh_plain(a, sweeps)
    if a.device.type != "cuda":
        raise ValueError(f"jacobi_eigh: unsupported device {a.device}")
    if a.dtype != torch.float32 or not a.is_contiguous():
        raise ValueError("jacobi_eigh: a must be contiguous float32")
    bsz, n, _ = a.shape
    w = torch.empty((bsz, n), dtype=torch.float32, device=a.device)
    v = torch.empty((bsz, n, n), dtype=torch.float32, device=a.device)
    # A stays in shared memory up to n = 240 (csrc/jacobi_eigh.cu:
    # jacobi_smem_bytes), beyond that in this workspace
    ws = torch.empty_like(a) if 4 * (2 * n + n * n) > _SMEM_BYTES else None
    if bsz:
        _build.call("basd_jacobi_eigh", a.data_ptr(), w.data_ptr(), v.data_ptr(),
                    0 if ws is None else ws.data_ptr(),
                    _device_table(n, a.device).data_ptr(), bsz, n, sweeps,
                    _build.stream_ptr(a.device))
        jacobi_eigh.launches += 1
    return _sorted(w, v)


jacobi_eigh.launches = 0


@functools.lru_cache(maxsize=None)
def _device_table(n: int, device: torch.device) -> torch.Tensor:
    """The pair table on ``device``, copied once per (n, device)."""
    return torch.from_numpy(pair_table(n)).to(device)
