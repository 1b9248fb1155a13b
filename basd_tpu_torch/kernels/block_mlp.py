"""K2 and K4: the fused MLP halves of the teacher and the student.

K2 replaces ``basd_tpu/ops/pallas/fused_block_mlp.py:fused_ln_mlp_collect``
(``_fwd_collect_kernel``)::

    out = x + mask * fc2(gelu_tanh(fc1(LN2(x))))
    buf[idx*B*N:(idx+1)*B*N] = out          (in place)

The in-place write of the caller's flat (L*B*N, D) collection buffer takes
the place of the TPU kernel's ``input_output_aliases``. K4 replaces
``fused_ln_mlp``, the same function without the buffer and with a VJP: K4a
(``_fwd``) is K2's entry point called with no buffer, K4b (``_bwd``)
recomputes from x and returns dx and the f32 gradients of every parameter,
summed over the batch. ``FusedLnMlp`` wraps them as a
``torch.autograd.Function`` that saves only x, mask and the parameters.

The CUDA kernels (``csrc/block.cu``: ``basd_block_mlp_collect_fwd``;
``csrc/block_train.cu``: ``basd_block_mlp_bwd``) run for bf16 CUDA tensors,
their ``_f32`` twins for f32 ones (the reference's f32 Pallas kernels:
tanh-GELU, full-f32 CUDA-core GEMMs, no TF32), and raise on any other
dtype; the ``*_plain`` functions are the same arithmetic in plain PyTorch,
taken for CPU tensors. Rounding follows the TPU kernels: LN output, fc1
output and GELU output rounded to x's dtype, GELU in f32, fc2 output
rounded to x's dtype, mask and residual in f32, rounded once; the
backward's rounding points are listed at ``block_mlp_plain_bwd``. Weights
are in torch's (out, in) layout.

At bf16 the two forward products of K2 and K4a (and of every other
``launch_gemm_nk`` caller) take ``csrc/gemm_sm90.cuh``'s wgmma GEMM when
``gemm_nk_variant`` says so; the wrappers count the products of each
variant in ``gemm_variants``.
"""

from __future__ import annotations

import torch

from basd_tpu_torch.kernels import _build
from basd_tpu_torch.kernels.block_attn import (
    _ROW_CHUNK,
    _check,
    _mm,
    split_k_chunk,
)
from basd_tpu_torch.kernels.layernorm import (
    layernorm_plain_fwd,
    ln_stats_plain,
    ln_vjp_rows,
)

_GELU_C = 0.7978845608028654  # sqrt(2/pi)
_GELU_A = 0.044715


def gelu_tanh(p: torch.Tensor) -> torch.Tensor:
    """tanh-approximate GELU (``jax.nn.gelu(approximate=True)``)."""
    t = torch.tanh(_GELU_C * (p + _GELU_A * p * p * p))
    return 0.5 * p * (1.0 + t)


def gelu_tanh_grad(p: torch.Tensor) -> torch.Tensor:
    """d/dp of ``gelu_tanh`` (``fused_mlp.py:_gelu_tanh_grad``)."""
    t = torch.tanh(_GELU_C * (p + _GELU_A * p * p * p))
    return 0.5 * (1.0 + t) + 0.5 * p * (1.0 - t * t) * _GELU_C * (
        1.0 + 3.0 * _GELU_A * p * p)


def block_mlp_plain(x, mask, ln_scale, ln_bias, w1, b1, w2, b2,
                    eps: float = 1e-6):
    b, n, d = x.shape
    xnb = layernorm_plain_fwd(x, ln_scale, ln_bias, eps)[0]
    pre = (_mm(xnb, w1) + b1).to(x.dtype).float()
    h = gelu_tanh(pre).to(x.dtype)
    y = (_mm(h, w2) + b2).to(x.dtype).float()
    m = mask.float().reshape(b, 1, 1)
    return (x.float() + y * m).to(x.dtype)


def block_mlp_plain_bwd(x, mask, dout, ln_scale, ln_bias, w1, b1, w2,
                        eps: float = 1e-6):
    """Recompute backward of K4 (``fused_block_mlp.py:95-135``).

    Returns (dx in x.dtype, dw1 (F, D), db1, dw2 (D, F), db2, dln_scale,
    dln_bias), the gradients f32. Rounding points (to x's dtype, the
    identity at f32): the LN output, pre-activation and hidden; dy =
    do * mask with a rounded copy; dh = dyb W2 f32; dpre = dh gelu'(preb)
    f32 with a rounded copy into dW1 and dxn; dW2 from the rounded hidden
    and dy; the LN VJP per row f32; dx = round(do + dxln).
    """
    dt = x.dtype
    xhat, _, rstd = ln_stats_plain(x, eps)
    xnb = (xhat * ln_scale.float() + ln_bias.float()).to(dt)
    pre = (_mm(xnb, w1) + b1).to(dt).float()
    hb = gelu_tanh(pre).to(dt)

    dof = dout.float()
    dy = dof * mask.float().reshape(-1, 1, 1)
    dyb = dy.to(dt).float()
    dh = torch.matmul(dyb, w2.float())
    dpre = dh * gelu_tanh_grad(pre)
    dpreb = dpre.to(dt).float()
    sum_bn = (0, 1)
    dw2 = torch.einsum("bnd,bnf->df", dyb, hb.float())
    dw1 = torch.einsum("bnf,bnd->fd", dpreb, xnb.float())
    dxn = torch.matmul(dpreb, w1.float())
    dxln = ln_vjp_rows(dxn, xhat, rstd, ln_scale)
    dx = (dof + dxln).to(dt)
    return (dx, dw1, dpre.sum(sum_bn), dw2, dy.sum(sum_bn),
            (dxn * xhat).sum(sum_bn), dxn.sum(sum_bn))


def gemm_nk_variant(dtype, n: int, k: int, ptrs) -> str:
    """The GEMM a forward product ``out (M, n) = A (M, k) . W (n, k)^T``
    takes, by ``csrc/gemm_sm90.cuh:gemm_nk_tile_n``'s rule (``n`` does not
    enter it; it sets the tile width, ``gemm_nk_tile_n``): ``'sm90'`` (the
    wgmma GEMM) for bf16 with k % 8 == 0 and every address in ``ptrs``
    (A, W and out) 16-byte aligned; ``'wmma'`` (common.cuh's tile) for
    other bf16 operands; ``'f32'`` (the CUDA-core tile) for f32."""
    if dtype == torch.float32:
        return "f32"
    if k > 0 and k % 8 == 0 and all(p % 16 == 0 for p in ptrs):
        return "sm90"
    return "wmma"


def gemm_nk_tile_n(n: int) -> int:
    """The sm90 GEMM's tile width for ``n`` output columns."""
    return 128 if n >= 256 else 64


def _check_mlp(name, x, mask, ln_scale, ln_bias, w1, b1, w2, b2, *extra):
    """Shape, type and device checks of the CUDA path: x (B, N, D) bf16 or
    f32, the weights in x's dtype, mask, LN affine and biases f32;
    ``extra``: further (name, tensor, dtype, shape) inputs."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    _mlp_dims(name, x, mask, ln_scale, ln_bias, w1, b1, w2, b2, *extra)


def _mlp_dims(name, x, mask, ln_scale, ln_bias, w1, b1, w2, b2, *extra):
    """``_check_mlp``'s type and shape rules, on any device."""
    if x.dim() != 3:
        raise ValueError(f"{name}: x must be (B, N, D), got {tuple(x.shape)}")
    dt, f32 = x.dtype, torch.float32
    if dt not in (torch.bfloat16, f32):
        raise ValueError(f"{name}: x must be bf16 or f32, got {dt}")
    b, n, d = x.shape
    f = w1.shape[0]
    if d % 8 or f % 8:
        raise ValueError(f"{name}: D={d}, F={f} must be % 8")
    params = [("x", x, dt, (b, n, d)), ("mask", mask, f32, (b,)),
              ("ln_scale", ln_scale, f32, (d,)), ("ln_bias", ln_bias, f32, (d,)),
              ("w1", w1, dt, (f, d)), ("b1", b1, f32, (f,)),
              ("w2", w2, dt, (d, f)), *extra]
    if b2 is not None:
        params.append(("b2", b2, f32, (d,)))
    for pname, t, dtype, shape in params:
        _check(pname, t, dtype, shape)
        if t.device != x.device:
            raise ValueError(f"{name}: all inputs must be on x's device")


def _mlp_fwd_call(fn, x, mask, ln_scale, ln_bias, w1, b1, w2, b2, buf_rows,
                  eps):
    """K2's entry (K4a's with no buffer); counts the launch and the
    variants of its two products on the wrapper ``fn``."""
    b, n, d = x.shape
    f = w1.shape[0]
    out = torch.empty_like(x)
    ws_xn = torch.empty((b * n, d), dtype=x.dtype, device=x.device)
    ws_h = torch.empty((b * n, f), dtype=x.dtype, device=x.device)
    _build.call(
        _build.entry("basd_block_mlp_collect_fwd", x.dtype),
        x.data_ptr(), mask.data_ptr(), ln_scale.data_ptr(),
        ln_bias.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), out.data_ptr(), buf_rows, ws_xn.data_ptr(),
        ws_h.data_ptr(), b, n, d, f, float(eps), _build.stream_ptr(x.device),
    )
    fn.launches += 1
    for ptrs, n_out, k in (((ws_xn, w1, ws_h), f, d), ((ws_h, w2, out), d, f)):
        variant = gemm_nk_variant(x.dtype, n_out, k,
                                  [t.data_ptr() for t in ptrs])
        fn.gemm_variants[variant] += 1
    return out


def gemm_nk_plain(a, w, bias):
    """``a (M, K) . w (N, K)^T + bias`` rounded once to a's dtype."""
    return (_mm(a, w) + bias.float()).to(a.dtype)


def gemm_nk(a, w, bias, tile_n: int = -1):
    """One forward product through ``launch_gemm_nk``'s bias epilogue
    (``csrc/block.cu:basd_gemm_nk``): a (M, K), w (N, K) bf16 CUDA tensors,
    bias (N,) f32; ``tile_n`` -1 takes the rule's GEMM, 0 the WMMA tile,
    64 or 128 the sm90 GEMM at that tile width. For holding the two GEMMs
    against each other and timing them; no kernel path calls it."""
    m, k = a.shape
    n = w.shape[0]
    for pname, t, dtype, shape in (("a", a, torch.bfloat16, (m, k)),
                                   ("w", w, torch.bfloat16, (n, k)),
                                   ("bias", bias, torch.float32, (n,))):
        _check(pname, t, dtype, shape)
    if a.device.type != "cuda":
        raise ValueError(f"gemm_nk: unsupported device {a.device}")
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    _build.call("basd_gemm_nk", a.data_ptr(), w.data_ptr(), bias.data_ptr(),
                out.data_ptr(), m, n, k, tile_n, _build.stream_ptr(a.device))
    return out


def fused_ln_mlp_collect(x, mask, ln_scale, ln_bias, w1, b1, w2, b2,
                         buf, idx: int, eps: float = 1e-6):
    """Returns ``out`` (B, N, D) and writes it into rows
    ``[idx*B*N, (idx+1)*B*N)`` of ``buf`` (L*B*N, D) in place; other rows
    are untouched.

    x, buf: bf16 or f32; mask: (B,) f32 stochastic-depth multipliers (ones
    for the deterministic teacher); w1: (F, D), w2: (D, F) in x's dtype; LN
    affine and biases f32.
    """
    b, n, d = x.shape
    m_rows = b * n
    if buf.dim() != 2 or buf.shape[1] != d or buf.dtype != x.dtype:
        raise ValueError(
            f"collect buffer {tuple(buf.shape)}/{buf.dtype} does not match "
            f"block output {tuple(x.shape)}/{x.dtype}"
        )
    if idx < 0 or (idx + 1) * m_rows > buf.shape[0]:
        raise ValueError(f"layer {idx} outside a {buf.shape[0]}-row stack")
    if x.device.type == "cpu":
        out = block_mlp_plain(x, mask, ln_scale, ln_bias, w1, b1, w2, b2, eps)
        buf[idx * m_rows:(idx + 1) * m_rows] = out.reshape(m_rows, d)
        return out
    _check_mlp("fused_ln_mlp_collect", x, mask, ln_scale, ln_bias, w1, b1, w2,
               b2, ("buf", buf, x.dtype, tuple(buf.shape)))
    buf_rows = buf.data_ptr() + idx * m_rows * d * buf.element_size()
    return _mlp_fwd_call(fused_ln_mlp_collect, x, mask, ln_scale, ln_bias, w1,
                         b1, w2, b2, buf_rows, eps)


def fused_ln_mlp_fwd(x, mask, ln_scale, ln_bias, w1, b1, w2, b2,
                     eps: float = 1e-6):
    """K4a: ``x + mask * fc2(gelu_tanh(fc1(LN(x))))`` (B, N, D) in x.dtype.

    x: bf16 or f32; mask: (B,) f32 stochastic-depth multipliers; w1:
    (F, D), w2: (D, F) in x's dtype; LN affine and biases f32.
    """
    if x.device.type == "cpu":
        return block_mlp_plain(x, mask, ln_scale, ln_bias, w1, b1, w2, b2, eps)
    _check_mlp("fused_ln_mlp_fwd", x, mask, ln_scale, ln_bias, w1, b1, w2, b2)
    return _mlp_fwd_call(fused_ln_mlp_fwd, x, mask, ln_scale, ln_bias, w1, b1,
                         w2, b2, None, eps)


def fused_ln_mlp_bwd(x, mask, dout, ln_scale, ln_bias, w1, b1, w2,
                     eps: float = 1e-6):
    """K4b: ``(dx in x's dtype, dw1, db1, dw2, db2, dln_scale,
    dln_bias)``, the gradients f32 and summed over the batch."""
    if x.device.type == "cpu":
        return block_mlp_plain_bwd(x, mask, dout, ln_scale, ln_bias, w1, b1,
                                   w2, eps)
    b, n, d = x.shape
    f = w1.shape[0]
    f32, dt = torch.float32, x.dtype
    _check_mlp("fused_ln_mlp_bwd", x, mask, ln_scale, ln_bias, w1, b1, w2,
               None, ("dout", dout, dt, (b, n, d)))
    m = b * n
    dev = x.device
    k_chunk = split_k_chunk(m, -(-f // 64) * -(-d // 64))
    splits = -(-m // k_chunk)
    chunks = -(-m // _ROW_CHUNK)
    dx = torch.empty_like(x)
    dw1 = torch.empty((f, d), dtype=f32, device=dev)
    db1 = torch.empty((f,), dtype=f32, device=dev)
    dw2 = torch.empty((d, f), dtype=f32, device=dev)
    db2, dln_s, dln_b = (torch.empty((d,), dtype=f32, device=dev)
                         for _ in range(3))
    ws_xn, ws_dyb = (torch.empty((m, d), dtype=dt, device=dev)
                     for _ in range(2))
    ws_pre, ws_h, ws_dpre = (torch.empty((m, f), dtype=dt, device=dev)
                             for _ in range(3))
    ws_stats = torch.empty((2 * m,), dtype=f32, device=dev)
    ws_f32 = torch.empty((m, d), dtype=f32, device=dev)
    ws_part = torch.empty(
        (max(splits * f * d, -(-m // 64) * f, 2 * chunks * d),), dtype=f32,
        device=dev)
    _build.call(
        _build.entry("basd_block_mlp_bwd", dt),
        x.data_ptr(), mask.data_ptr(), dout.data_ptr(), ln_scale.data_ptr(),
        ln_bias.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        dx.data_ptr(), dw1.data_ptr(), db1.data_ptr(), dw2.data_ptr(),
        db2.data_ptr(), dln_s.data_ptr(), dln_b.data_ptr(), ws_xn.data_ptr(),
        ws_stats.data_ptr(), ws_pre.data_ptr(), ws_h.data_ptr(),
        ws_dyb.data_ptr(), ws_dpre.data_ptr(), ws_f32.data_ptr(),
        ws_part.data_ptr(), b, n, d, f, k_chunk, _ROW_CHUNK, float(eps),
        _build.stream_ptr(dev),
    )
    fused_ln_mlp_bwd.launches += 1
    return dx, dw1, db1, dw2, db2, dln_s, dln_b


fused_ln_mlp_collect.launches = 0
fused_ln_mlp_fwd.launches = 0
fused_ln_mlp_bwd.launches = 0
# forward products by GEMM variant (gemm_nk_variant), two a launch
fused_ln_mlp_collect.gemm_variants = {"sm90": 0, "wmma": 0, "f32": 0}
fused_ln_mlp_fwd.gemm_variants = {"sm90": 0, "wmma": 0, "f32": 0}


class FusedLnMlp(torch.autograd.Function):
    """K4a forward, K4b backward; the mask is not differentiated."""

    @staticmethod
    def forward(ctx, x, mask, ln_scale, ln_bias, w1, b1, w2, b2, eps):
        out = fused_ln_mlp_fwd(x, mask, ln_scale, ln_bias, w1, b1, w2, b2, eps)
        ctx.save_for_backward(x, mask, ln_scale, ln_bias, w1, b1, w2, b2)
        ctx.eps = eps
        return out

    @staticmethod
    def backward(ctx, dout):
        x, mask, ln_s, ln_b, w1, b1, w2, b2 = ctx.saved_tensors
        dx, dw1, db1, dw2, db2, dls, dlb = fused_ln_mlp_bwd(
            x, mask, dout.to(x.dtype).contiguous(), ln_s, ln_b, w1, b1, w2,
            ctx.eps)
        return (dx, None, dls.to(ln_s.dtype), dlb.to(ln_b.dtype),
                dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype),
                db2.to(b2.dtype), None)


def fused_ln_mlp(x, mask, ln_scale, ln_bias, w1, b1, w2, b2,
                 eps: float = 1e-6):
    """``x + mask * fc2(gelu_tanh(fc1(LN(x))))``, differentiable (K4a/K4b)."""
    return FusedLnMlp.apply(x.contiguous(), mask, ln_scale, ln_bias, w1, b1,
                            w2, b2, eps)
