"""K5: LayerNorm over the last axis of (B, N, D) with its VJP.

Replaces ``basd_tpu/ops/pallas/layernorm.py:fused_layernorm``: the forward
``_fwd`` (``_fwd_kernel``: f32 two-pass statistics, output in x.dtype, the
row mean and rstd (B, N) f32 kept for the backward) and the backward
``_bwd`` (``_bwd_kernel``: the row VJP
``dx = rstd * (g - mean(g) - xhat * mean(g * xhat))``, ``g = dy * scale``,
and dscale/dbias as per-program partials summed afterwards).

What bounds both on the H100: one read and one write of the activation
slab (student (128, 197, 192) bf16, 9.7 MB each way; a few microseconds at
3.35 TB/s), with a handful of flops per element.

K5a is CUDA (``csrc/layernorm.cuh``, entries ``basd_layernorm_fwd`` and its
``_f32`` twin in ``csrc/layernorm.cu``): the one LayerNorm forward of the
port, which the block kernels K1-K4 launch too. A fixed group of lanes
owns a row, holds it in registers between the two passes and moves it in
16-byte accesses (at D=192 in bf16, 4 lanes of 6 chunks each); rows whose
width is not a whole number of 16-byte chunks take a scalar loop of the
same kernel. No Triton launcher sits in front of it.

K5b is Triton. It runs on a fixed grid of ``_BWD_PROGRAMS`` row programs
(two per SM of an H100; a constant, so the partial layout and the
summation order never depend on the card). Program p walks its contiguous
range of rows (``ln_bwd_partition``) in steps of a few rows, keeps its
dscale and dbias partials in registers across the walk and writes one
(2, D) row at the end; one more launch sums the ``_BWD_PROGRAMS`` partial
rows of both, in program order (deterministic, no atomics: two calls give
equal bits), spread over ``2 D / _SUM_BLOCK`` programs.

A step is ``_BWD_ELEMS // BLOCK_D`` rows (32 at D=192, 16 at D=384) on
``_BWD_WARPS`` = 2 warps, 128 elements a thread of each operand: the
fastest of 4 x 3 (rows, warps) choices at the student's (128, 197, 192)
in device time on an H100 80GB HBM3 at 700 W (``basd_tpu_torch/tune.py``:
0.0223 ms, 1.31 TB/s, against aten's 0.102 ms; 16 rows 0.0244, 4 warps
0.028, 64 rows on 2 warps 0.48). ``BLOCK_D`` stays a power of two: at D=192 a
quarter of the lanes is masked, yet the same sweep at D=256 moved bytes
only 6% faster (1.39 against 1.31 TB/s), so the row is not split.

The plain versions are the same two-pass arithmetic in PyTorch, taken for
CPU tensors. ``layernorm_fwd``/``layernorm_bwd`` are the counted wrappers;
``fused_layernorm`` is the differentiable function.
"""

from __future__ import annotations

import torch

from basd_tpu_torch.kernels import _build

_BWD_PROGRAMS = 264  # the backward's row programs: 2 x the H100's 132 SMs
_BWD_ELEMS = 8192  # elements of a backward step: rows x the padded row
_BWD_WARPS = 2
_SUM_BLOCK = 32  # columns per program of the partial sums' launch
_TRITON: dict = {}


def _kernels() -> dict:
    """Compile-on-first-use Triton kernels (triton imports only here)."""
    if _TRITON:
        return _TRITON
    global triton, tl
    import triton
    import triton.language as tl

    @triton.jit
    def ln_bwd_kernel(x_ptr, w_ptr, mu_ptr, rstd_ptr, dy_ptr, dx_ptr, part_ptr,
                      m, d, per, blocks, ROWS: tl.constexpr,
                      BLOCK_D: tl.constexpr):
        # rows [pid * per, min(m, (pid + 1) * per)) in blocks of ROWS; one
        # (2, d) partial row (dscale, dbias) per program
        pid = tl.program_id(0)
        start = pid * per
        end = tl.minimum(start + per, m)
        cols = tl.arange(0, BLOCK_D)
        cmask = cols < d
        w = tl.load(w_ptr + cols, mask=cmask, other=0.0)
        acc_w = tl.zeros((BLOCK_D,), dtype=tl.float32)
        acc_b = tl.zeros((BLOCK_D,), dtype=tl.float32)
        for i in range(0, blocks):
            rows = start + i * ROWS + tl.arange(0, ROWS)
            rmask = rows < end
            m2 = rmask[:, None] & cmask[None, :]
            offs = rows[:, None] * d + cols[None, :]
            x = tl.load(x_ptr + offs, mask=m2, other=0.0).to(tl.float32)
            dy = tl.load(dy_ptr + offs, mask=m2, other=0.0).to(tl.float32)
            mu = tl.load(mu_ptr + rows, mask=rmask, other=0.0)
            rstd = tl.load(rstd_ptr + rows, mask=rmask, other=0.0)
            xhat = tl.where(m2, (x - mu[:, None]) * rstd[:, None], 0.0)
            g = dy * w[None, :]
            mg = tl.sum(g, axis=1) / d
            mgx = tl.sum(g * xhat, axis=1) / d
            dx = rstd[:, None] * (g - mg[:, None] - xhat * mgx[:, None])
            tl.store(dx_ptr + offs, dx.to(dx_ptr.dtype.element_ty), mask=m2)
            acc_w += tl.sum(dy * xhat, axis=0)
            acc_b += tl.sum(dy, axis=0)
        tl.store(part_ptr + pid * 2 * d + cols, acc_w, mask=cmask)
        tl.store(part_ptr + pid * 2 * d + d + cols, acc_b, mask=cmask)

    @triton.jit
    def colsum_kernel(part_ptr, out_ptr, n, PROGRAMS: tl.constexpr,
                      BLOCK: tl.constexpr):
        # out[j] = sum of part[p, j] over the PROGRAMS rows, p in order
        cols = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        cmask = cols < n
        acc = tl.zeros((BLOCK,), dtype=tl.float32)
        for p in tl.static_range(PROGRAMS):
            acc += tl.load(part_ptr + p * n + cols, mask=cmask, other=0.0)
        tl.store(out_ptr + cols, acc, mask=cmask)

    _TRITON.update(bwd=ln_bwd_kernel, colsum=colsum_kernel)
    return _TRITON


def _block_d(d: int) -> int:
    return 1 << max(0, (d - 1).bit_length())


def ln_bwd_partition(m: int, programs: int,
                     rows: int) -> tuple[int, int]:
    """K5b's row partition: ``(per, blocks)``, program p owning rows
    ``[p * per, min(m, (p + 1) * per))`` in ``blocks`` steps of ``rows``.
    ``per`` is the least multiple of ``rows`` with ``programs * per >= m``,
    so the programs cover rows 0..m-1 once each, in order; the last may own
    none (their partial rows are zeros)."""
    blocks = max(1, -(-m // (programs * rows)))
    return blocks * rows, blocks


def ln_stats_plain(x, eps: float = 1e-6):
    """Two-pass f32 statistics of the last axis: (xhat, mu, rstd), xhat
    f32 like x, mu and rstd without the last axis."""
    d = x.shape[-1]
    xf = x.float()
    mu = xf.sum(-1) * (1.0 / d)
    xc = xf - mu[..., None]
    rstd = torch.rsqrt((xc * xc).sum(-1) * (1.0 / d) + eps)
    return xc * rstd[..., None], mu, rstd


def layernorm_plain_fwd(x, scale, bias, eps: float = 1e-6):
    """Returns (out in x.dtype, mu, rstd), the statistics (B, N) f32."""
    xhat, mu, rstd = ln_stats_plain(x, eps)
    return (xhat * scale.float() + bias.float()).to(x.dtype), mu, rstd


def ln_vjp_rows(g_in, xhat, rstd, scale):
    """The LayerNorm VJP of one row in f32: ``g = g_in * scale``,
    ``rstd * (g - mean(g) - xhat * mean(g * xhat))``."""
    d = g_in.shape[-1]
    g = g_in * scale.float()
    mg = g.sum(-1, keepdim=True) * (1.0 / d)
    mgx = (g * xhat).sum(-1, keepdim=True) * (1.0 / d)
    return rstd[..., None] * (g - mg - xhat * mgx)


def layernorm_plain_bwd(x, scale, mu, rstd, dy):
    """Returns (dx in x.dtype, dscale f32, dbias f32)."""
    xhat = (x.float() - mu[..., None]) * rstd[..., None]
    dyf = dy.float()
    dx = ln_vjp_rows(dyf, xhat, rstd, scale).to(x.dtype)
    dims = tuple(range(x.dim() - 1))
    return dx, (dyf * xhat).sum(dims), dyf.sum(dims)


def _check_cuda(name, x, *tensors):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dim() != 3 or x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: x must be (B, N, D) bf16 or f32, got "
                         f"{x.dtype} {tuple(x.shape)}")
    for t in (x, *tensors):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous on {x.device}")


def layernorm_fwd(x, scale, bias, eps: float = 1e-6):
    """K5a: (out in x.dtype, mu (B, N) f32, rstd (B, N) f32)."""
    if x.device.type == "cpu":
        return layernorm_plain_fwd(x, scale, bias, eps)
    out = _ln_fwd_launch(x, scale, bias, eps, 0)
    layernorm_fwd.launches += 1
    return out


def _ln_fwd_launch(x, scale, bias, eps: float, chunks: int):
    """K5a's launch; ``chunks`` the 16-byte chunks a lane aims for, 0 for
    the kernel's own (``csrc/layernorm.cuh:LN_CHUNKS``; ``tune.py`` sweeps
    others)."""
    scale, bias = scale.float().contiguous(), bias.float().contiguous()
    _check_cuda("layernorm_fwd", x, scale, bias)
    b, n, d = x.shape
    out = torch.empty_like(x)
    mu = torch.empty((b, n), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mu)
    _build.call(_build.entry("basd_layernorm_fwd", x.dtype), x.data_ptr(),
                scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
                mu.data_ptr(), rstd.data_ptr(), b * n, d, float(eps), chunks,
                _build.stream_ptr(x.device))
    return out, mu, rstd


def layernorm_bwd(x, scale, mu, rstd, dy):
    """K5b: (dx in x.dtype, dscale f32, dbias f32)."""
    if x.device.type == "cpu":
        return layernorm_plain_bwd(x, scale, mu, rstd, dy)
    rows = max(1, _BWD_ELEMS // _block_d(x.shape[-1]))
    out = _ln_bwd_launch(x, scale, mu, rstd, dy, rows, _BWD_WARPS)
    layernorm_bwd.launches += 1
    return out


def _ln_bwd_launch(x, scale, mu, rstd, dy, rows: int, num_warps: int):
    """K5b's two launches at ``rows`` rows a step and ``num_warps`` warps a
    row program (``layernorm_bwd`` passes the tuned constants)."""
    scale = scale.float().contiguous()
    dy = dy.contiguous()
    _check_cuda("layernorm_bwd", x, scale, mu, rstd, dy)
    b, n, d = x.shape
    m = b * n
    per, blocks = ln_bwd_partition(m, _BWD_PROGRAMS, rows)
    dx = torch.empty_like(x)
    part = torch.empty((_BWD_PROGRAMS, 2 * d), dtype=torch.float32,
                       device=x.device)
    sums = torch.empty((2 * d,), dtype=torch.float32, device=x.device)
    k = _kernels()
    k["bwd"][(_BWD_PROGRAMS,)](x, scale, mu, rstd, dy, dx, part, m, d, per,
                               blocks, ROWS=rows, BLOCK_D=_block_d(d),
                               num_warps=num_warps)
    k["colsum"][(-(-2 * d // _SUM_BLOCK),)](part, sums, 2 * d,
                                            PROGRAMS=_BWD_PROGRAMS,
                                            BLOCK=_SUM_BLOCK, num_warps=1)
    return dx, sums[:d], sums[d:]


layernorm_fwd.launches = 0
layernorm_bwd.launches = 0


class FusedLayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        out, mu, rstd = layernorm_fwd(x, scale, bias, eps)
        ctx.save_for_backward(x, scale, mu, rstd)
        return out

    @staticmethod
    def backward(ctx, dy):
        x, scale, mu, rstd = ctx.saved_tensors
        dx, dw, db = layernorm_bwd(x, scale, mu, rstd, dy.to(x.dtype))
        return dx, dw.to(scale.dtype), db.to(scale.dtype), None


def fused_layernorm(x, scale, bias, eps: float = 1e-6):
    """LayerNorm over the last axis of (B, N, D): K5a forward, K5b VJP."""
    return FusedLayerNorm.apply(x.contiguous(), scale, bias, eps)
