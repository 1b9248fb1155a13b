"""Spectral linear-algebra core (counterpart of ``basd_tpu/ops/linalg.py``).

Every SVD the BASD path needs is a symmetric eigenproblem here, as in the
reference: singular values via the smaller Gram's eigenvalues, subspaces
via Gram eigenvectors, the nuclear-norm subgradient via a Newton-Schulz
polar factor. ``safe_eigh`` and ``eigvalsh_only`` are
``torch.autograd.Function``s with the reference's degeneracy-safe
backwards; their forward (``impl="xla"``, the reference's XLA eigh) is K8
converged (``kernels/converged_eigh.py``) on an f32 CUDA tensor up to n =
512 and ``torch.linalg.eigh`` elsewhere, or, with ``impl="jacobi"``, K8 at six
sweeps (``kernels/jacobi_eigh.py``). ``backend="svd"`` keeps
``torch.linalg.svd`` as the parity path.

Precision policy (the reference's ``HI``): spectral-path f32 products run
at full f32. PyTorch's CPU matmul is full f32; on the card
``set_full_f32_precision`` turns TF32 off for matmuls and for cuDNN
convolutions, which take TF32 by default.
"""

from __future__ import annotations

import math

import torch

from basd_tpu_torch.kernels import ns_polar as _ns
from basd_tpu_torch.kernels.converged_eigh import MAX_N as _CONVERGED_MAX_N
from basd_tpu_torch.kernels.converged_eigh import converged_eigh
from basd_tpu_torch.kernels.jacobi_eigh import jacobi_eigh
from basd_tpu_torch.utils import trace

_SAFE_EIG_FLOOR = 1e-30
_EIGH_GRAD_CLAMP = 1e-6


def set_full_f32_precision() -> None:
    """Full-f32 matmuls and convolutions (no TF32) for the whole process."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _sym(a: torch.Tensor) -> torch.Tensor:
    # jnp.linalg.eigh symmetrizes its input by default
    return (a + a.transpose(-1, -2)) / 2.0


def _safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    """sqrt with zero (not inf/nan) gradient at x <= 0."""
    ok = x > _SAFE_EIG_FLOOR
    safe = torch.sqrt(torch.where(ok, x, torch.full_like(x, _SAFE_EIG_FLOOR)))
    return torch.where(ok, safe, torch.zeros_like(x))


# K8 runs 6 sweeps, as the reference's ``_eigh_impl`` (``linalg.py:94-100``):
# the BASD matrices are PSD Grams with decaying or [0, 1]-clustered spectra
JACOBI_SWEEPS = 6


def _eigh_route(a: torch.Tensor, impl: str) -> str:
    """The route of an eigh call: 'converged' (K8 converged) for the 'xla'
    impl on an f32 CUDA tensor of n <= 512, else the impl itself. Beyond
    512 ``torch.linalg.eigh`` leaves Jacobi for divide and conquer, more
    accurate and faster there (the CLI's calibration decomposes the
    teacher's 768- or 1024-wide covariance)."""
    if (impl == "xla" and a.device.type == "cuda" and a.dtype == torch.float32
            and a.shape[-1] <= _CONVERGED_MAX_N):
        return "converged"
    return impl


def _eigh_impl(a: torch.Tensor, impl: str):
    """Forward eigh dispatch (``_eigh_route``). 'xla' (the reference's QDWH
    custom call): K8 converged, run to convergence on the card, or
    ``torch.linalg.eigh`` (the CPU, where the parity tests hold it to
    ``jnp.linalg.eigh``); 'jacobi': K8's parallel Jacobi at six sweeps. The
    tracer counts the calls and the matrices of each route
    (``eigh.calls.<route>``, ``eigh.matrices.<route>``: ``converged``,
    ``xla``, ``jacobi``)."""
    n = a.shape[-1]
    route = _eigh_route(a, impl)
    if trace.enabled():
        trace.count(f"eigh.calls.{route}")
        trace.count(f"eigh.matrices.{route}", math.prod(a.shape[:-2]))
    with trace.span("eigh"):
        if route == "jacobi":
            w, v = jacobi_eigh(a.reshape(-1, n, n).float().contiguous(),
                               sweeps=JACOBI_SWEEPS)
            return w.reshape(a.shape[:-1]), v.reshape(a.shape)
        if route == "converged":
            w, v, _ = converged_eigh(a.reshape(-1, n, n).contiguous())
            return w.reshape(a.shape[:-1]), v.reshape(a.shape)
        return torch.linalg.eigh(_sym(a))


class _EigvalshOnly(torch.autograd.Function):
    """Ascending eigenvalues with the vector-based backward
    ``dA = V diag(dw) V^T`` (no gap denominators)."""

    @staticmethod
    def forward(ctx, a, impl):
        w, v = _eigh_impl(a, impl)
        ctx.save_for_backward(v)
        return w

    @staticmethod
    def backward(ctx, dw):
        (v,) = ctx.saved_tensors
        return torch.matmul(v * dw[..., None, :], v.transpose(-1, -2)), None


def eigvalsh_only(a: torch.Tensor, impl: str = "xla") -> torch.Tensor:
    return _EigvalshOnly.apply(a, impl)


class _SafeEigh(torch.autograd.Function):
    """Batched symmetric eigh (ascending) whose backward clamps the
    1/(lambda_j - lambda_i) factors at degeneracies."""

    @staticmethod
    def forward(ctx, a, impl):
        w, v = _eigh_impl(a, impl)
        ctx.save_for_backward(w, v)
        return w, v

    @staticmethod
    def backward(ctx, dw, dv):
        w, v = ctx.saved_tensors
        diffs = w[..., None, :] - w[..., :, None]
        sign = torch.where(diffs >= 0, 1.0, -1.0)
        denom = sign * torch.clamp(diffs.abs(), min=_EIGH_GRAD_CLAMP)
        eye = torch.eye(w.shape[-1], dtype=w.dtype, device=w.device)
        f = (1.0 / denom) * (1.0 - eye)
        vt_dv = torch.matmul(v.transpose(-1, -2), dv)
        inner = f * vt_dv + eye * dw[..., None, :]
        da = torch.matmul(torch.matmul(v, inner), v.transpose(-1, -2))
        return (da + da.transpose(-1, -2)) / 2.0, None


def safe_eigh(a: torch.Tensor, impl: str = "xla"):
    return _SafeEigh.apply(a, impl)


def safe_eigh_desc(a: torch.Tensor, impl: str = "xla"):
    vals, vecs = safe_eigh(a, impl)
    return vals.flip(-1), vecs.flip(-1)


def singular_values_gram(m: torch.Tensor, impl: str = "xla") -> torch.Tensor:
    """Descending singular values of ``m`` (..., r, c) via the smaller
    Gram (differentiable, degeneracy-stable backward)."""
    r, c = m.shape[-2], m.shape[-1]
    mt = m.transpose(-1, -2)
    gram = torch.matmul(m, mt) if r <= c else torch.matmul(mt, m)
    return _safe_sqrt(eigvalsh_only(gram, impl).flip(-1))


def singular_values(m: torch.Tensor, backend: str = "gram") -> torch.Tensor:
    """Descending singular values by backend: the Gram eigenvalues ('gram'
    by the 'xla' route, 'jacobi' by K8) or ``torch.linalg.svdvals``
    ('svd', the parity backend)."""
    if backend == "gram":
        return singular_values_gram(m)
    if backend == "jacobi":
        return singular_values_gram(m, impl="jacobi")
    if backend == "svd":
        return torch.linalg.svdvals(m)
    raise ValueError(f"unknown backend {backend!r}")


def right_singular_vectors(x: torch.Tensor, backend: str = "gram"):
    """Descending singular values and right singular vectors of ``x``
    (..., m, n): from the eigendecomposition of the (n, n) Gram ``x^T x``,
    or ``torch.linalg.svd`` for 'svd' (``v = Vh^T``); columns of ``v`` up
    to sign."""
    if backend == "svd":
        _, s, vh = torch.linalg.svd(x, full_matrices=False)
        return s, vh.transpose(-1, -2)
    impl = "jacobi" if backend == "jacobi" else "xla"
    vals, vecs = safe_eigh_desc(torch.matmul(x.transpose(-1, -2), x), impl)
    return _safe_sqrt(vals), vecs


def rank_one_update_eigvals(w: torch.Tensor, c: torch.Tensor, rho: float,
                            iters: int = 40) -> torch.Tensor:
    """Ascending eigenvalues of ``diag(w) + rho c c^T`` (rho > 0) by
    vectorised bisection on the secular equation over the interlacing
    intervals (Golub 1973)."""
    c2 = c * c
    hi_last = w[..., -1:] + rho * c2.sum(-1, keepdim=True)
    lo = w
    hi = torch.cat([w[..., 1:], hi_last], dim=-1)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        diff = w[..., None, :] - mid[..., :, None]
        diff = torch.where(diff.abs() < 1e-30, torch.full_like(diff, 1e-30),
                           diff)
        below = (1.0 + rho * (c2[..., None, :] / diff).sum(-1)) < 0
        lo, hi = torch.where(below, mid, lo), torch.where(below, hi, mid)
    return 0.5 * (lo + hi)


def newton_schulz_polar(m: torch.Tensor, steps: int = 18,
                        inner_dtype: torch.dtype = torch.bfloat16,
                        schedule: str = "cubic") -> torch.Tensor:
    """Polar factor ``U V^T`` of ``m`` (..., r, c) by Newton-Schulz.

    ``'cubic'``: ``steps`` iterations of ``X <- 1.5 X - 0.5 X X^T X`` after
    Frobenius prescaling. ``'hybrid'``: 5 quintic + 2 cubic steps. The bf16
    hybrid schedule goes to K7 (``kernels.ns_polar``) under the reference's
    shape gate (``linalg.py:296-314``); everything else runs here.
    """
    if schedule == "hybrid" and inner_dtype == torch.bfloat16 and m.dim() >= 3:
        *batch, r, c = m.shape
        flip = r > c
        rr, cc = (c, r) if flip else (r, c)
        if _ns.kernel_eligible(rr, cc):
            x = m.float().reshape(-1, r, c)
            if flip:
                x = x.transpose(-1, -2)
            p = _ns.ns_polar_hybrid(x.contiguous())
            if flip:
                p = p.transpose(-1, -2)
            return p.reshape(m.shape).to(m.dtype)
    if schedule == "hybrid":
        p = _ns.ns_polar_plain(m, inner_dtype)
    else:
        p = _ns.ns_polar_plain(m, inner_dtype, quintic=(), num_cubic=steps)
    return p.to(m.dtype)


class _NuclearNorm(torch.autograd.Function):
    """Sum of singular values (Gram eigh) with the Newton-Schulz polar
    factor as its backward (the nuclear-norm subgradient)."""

    @staticmethod
    def forward(ctx, m):
        ctx.save_for_backward(m)
        return singular_values_gram(m).sum(-1)

    @staticmethod
    def backward(ctx, g):
        (m,) = ctx.saved_tensors
        polar = newton_schulz_polar(m, schedule="hybrid")
        return g[..., None, None] * polar


def nuclear_norm(m: torch.Tensor) -> torch.Tensor:
    """Nuclear norm of ``m`` (..., r, c) -> (...)."""
    return _NuclearNorm.apply(m)


def nuclear_norm_ref(m: torch.Tensor) -> torch.Tensor:
    """Parity backend: the nuclear norm from ``torch.linalg.svdvals``
    (its SVD backward)."""
    return torch.linalg.svdvals(m).sum(-1)


class _NuclearNormNS(torch.autograd.Function):
    """``||M||_* = tr(P^T M)`` with P the Newton-Schulz polar factor of M,
    first-order insensitive to errors in P; the one polar factor serves the
    value and, as the subgradient, the backward."""

    @staticmethod
    def forward(ctx, m):
        p = newton_schulz_polar(m, schedule="hybrid")
        ctx.save_for_backward(p)
        return (p.float() * m.float()).sum(dim=(-2, -1))

    @staticmethod
    def backward(ctx, g):
        (p,) = ctx.saved_tensors
        return g[..., None, None] * p


def nuclear_norm_ns(m: torch.Tensor) -> torch.Tensor:
    """Nuclear norm via the polar factor alone (no eigendecomposition)."""
    return _NuclearNormNS.apply(m)


def orthogonal_matrix(generator: torch.Generator, rows: int, cols: int,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Random (rows, cols) matrix with orthonormal rows (rows <= cols) or
    columns, Haar-distributed (``torch.nn.init.orthogonal_`` semantics)."""
    flat = torch.randn((max(rows, cols), min(rows, cols)), generator=generator)
    q, r = torch.linalg.qr(flat)
    q = q * torch.sign(torch.diagonal(r))[None, :]
    if rows < cols:
        q = q.t()
    return q.to(dtype).contiguous()
