"""K11: the fused MLP ``fc2(gelu_tanh(fc1(x)))``, the ``fused`` MLP impl.

Replaces ``basd_tpu/ops/pallas/fused_mlp.py:fused_mlp``: K11a
``fused_mlp_fwd`` (``_fwd``) and K11b ``fused_mlp_bwd`` (``_bwd``), the
recompute VJP returning dx and the f32 gradients dw1, db1, dw2, db2 summed
over the rows. ``FusedMlp`` wraps them as a ``torch.autograd.Function``
that saves only x and the weights; as the JAX package's VJP it returns the
weight gradients in the weights' dtype and both bias gradients in b1's.

The CUDA kernels (``csrc/fused_mlp.cu``) run for bf16 CUDA tensors (WMMA
tensor-core GEMMs) and f32 CUDA tensors (CUDA-core f32 GEMMs with the same
epilogues, full f32, no TF32) and raise on any other CUDA dtype; the
``*_plain`` functions are the same arithmetic in plain PyTorch, taken for
CPU tensors of any float dtype.
Rounding follows the TPU kernel: operands in x's dtype, f32 accumulation,
the pre-activation rounded to x's dtype before an f32 tanh-GELU (tanh at
every dtype: the fused MLP never takes erf), the hidden state rounded into
fc2, ``out = (acc + b2)`` rounded once; the backward's points are listed at
``fused_mlp_plain_bwd``. Weights are in torch's (out, in) layout, the
transpose of the JAX kernel's (in, out).
"""

from __future__ import annotations

import torch

from basd_tpu_torch.kernels import _build
from basd_tpu_torch.kernels.block_attn import _ROW_CHUNK, _check, _mm, split_k_chunk
from basd_tpu_torch.kernels.block_mlp import gelu_tanh, gelu_tanh_grad


def fused_mlp_plain_fwd(x, w1, b1, w2, b2):
    """(B, N, Do) in x.dtype; w1 (F, D), w2 (Do, F)."""
    dt = x.dtype
    pre = (_mm(x, w1) + b1.float()).to(dt).float()
    h = gelu_tanh(pre).to(dt)
    return (_mm(h, w2) + b2.float()).to(dt)


def fused_mlp_plain_bwd(x, dout, w1, b1, w2):
    """Recompute backward of K11 (``fused_mlp.py:93-133``).

    Returns (dx in x.dtype, dw1 (F, D), db1 (F), dw2 (Do, F), db2 (Do)),
    the gradients f32. ``dout`` is already in x's dtype. Rounding points:
    pre in x's dtype, hidden in x's dtype into dW2; dh = do W2 and
    dpre = dh gelu'(pre) in f32, db1 its sum before the copy in x's dtype
    that goes into dW1 and dx.
    """
    dt = x.dtype
    x2 = x.reshape(-1, x.shape[-1])
    do2 = dout.reshape(-1, dout.shape[-1]).float()
    pre = (_mm(x2, w1) + b1.float()).to(dt).float()
    hb = gelu_tanh(pre).to(dt).float()
    dw2 = torch.matmul(do2.t(), hb)
    dh = torch.matmul(do2, w2.float())
    dpre = dh * gelu_tanh_grad(pre)
    dpreb = dpre.to(dt).float()
    dw1 = torch.matmul(dpreb.t(), x2.float())
    dx = torch.matmul(dpreb, w1.float()).to(dt)
    return dx.reshape(x.shape), dw1, dpre.sum(0), dw2, do2.sum(0)


def _mlp_dims(name, x, w1, b1, w2, *extra):
    """Type and shape rules of the CUDA path, on any device: x (B, N, D)
    bf16 or f32, the weights in x's dtype, b1 f32; ``extra``: further
    (name, tensor, dtype, shape) inputs. Returns (M, D, F, Do)."""
    if x.dim() != 3:
        raise ValueError(f"{name}: x must be (B, N, D), got {tuple(x.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: x must be bf16 or f32, got {x.dtype}")
    b, n, d = x.shape
    f, do_ = w1.shape[0], w2.shape[0]
    if d % 8 or f % 8 or do_ % 8:
        raise ValueError(f"{name}: D={d}, F={f}, Do={do_} must be % 8")
    dt, f32 = x.dtype, torch.float32
    for pname, t, dtype, shape in [("x", x, dt, (b, n, d)),
                                   ("w1", w1, dt, (f, d)), ("b1", b1, f32, (f,)),
                                   ("w2", w2, dt, (do_, f)), *extra]:
        _check(pname, t, dtype, shape)
        if t.device != x.device:
            raise ValueError(f"{name}: all inputs must be on x's device")
    return b * n, d, f, do_


def _check_mlp(name, x, w1, b1, w2, *extra):
    """``_mlp_dims`` for a CUDA tensor; raises on any other device."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    return _mlp_dims(name, x, w1, b1, w2, *extra)



def fused_mlp_fwd(x, w1, b1, w2, b2):
    """K11a: ``fc2(gelu_tanh(fc1(x)))`` (B, N, Do) in x.dtype.

    x: (B, N, D) bf16 or f32; w1: (F, D), w2: (Do, F) in x's dtype;
    b1, b2: f32.
    """
    if x.device.type == "cpu":
        return fused_mlp_plain_fwd(x, w1, b1, w2, b2)
    m, d, f, do_ = _check_mlp("fused_mlp_fwd", x, w1, b1, w2,
                              ("b2", b2, torch.float32, (w2.shape[0],)))
    out = torch.empty(x.shape[:-1] + (do_,), dtype=x.dtype, device=x.device)
    ws_h = torch.empty((m, f), dtype=x.dtype, device=x.device)
    _build.call(_build.entry("basd_fused_mlp_fwd", x.dtype), x.data_ptr(),
                w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                out.data_ptr(),
                ws_h.data_ptr(), m, d, f, do_, _build.stream_ptr(x.device))
    fused_mlp_fwd.launches += 1
    return out


def fused_mlp_bwd(x, dout, w1, b1, w2):
    """K11b: ``(dx in x's dtype, dw1, db1, dw2, db2)``, the gradients f32
    and summed over the rows."""
    if x.device.type == "cpu":
        return fused_mlp_plain_bwd(x, dout, w1, b1, w2)
    m, d, f, do_ = _check_mlp(
        "fused_mlp_bwd", x, w1, b1, w2,
        ("dout", dout, x.dtype, x.shape[:-1] + (w2.shape[0],)))
    dev = x.device
    f32 = torch.float32
    k_chunk = split_k_chunk(m, -(-f // 64) * -(-max(d, do_) // 64))
    splits = -(-m // k_chunk)
    chunks = -(-m // _ROW_CHUNK)
    dx = torch.empty_like(x)
    dw1 = torch.empty((f, d), dtype=f32, device=dev)
    db1 = torch.empty((f,), dtype=f32, device=dev)
    dw2 = torch.empty((do_, f), dtype=f32, device=dev)
    db2 = torch.empty((do_,), dtype=f32, device=dev)
    ws_pre, ws_h, ws_dpre = (torch.empty((m, f), dtype=x.dtype, device=dev)
                             for _ in range(3))
    ws_part = torch.empty(
        (max(splits * f * max(d, do_), -(-m // 64) * f, chunks * do_),),
        dtype=f32, device=dev)
    _build.call(
        _build.entry("basd_fused_mlp_bwd", x.dtype), x.data_ptr(),
        dout.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), dx.data_ptr(), dw1.data_ptr(),
        db1.data_ptr(), dw2.data_ptr(), db2.data_ptr(), ws_pre.data_ptr(),
        ws_h.data_ptr(), ws_dpre.data_ptr(), ws_part.data_ptr(), m, d, f, do_,
        k_chunk, _ROW_CHUNK, _build.stream_ptr(dev),
    )
    fused_mlp_bwd.launches += 1
    return dx, dw1, db1, dw2, db2


fused_mlp_fwd.launches = 0
fused_mlp_bwd.launches = 0


class FusedMlp(torch.autograd.Function):
    """K11a forward (saves x and the weights), K11b backward."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        out = fused_mlp_fwd(x, w1, b1, w2, b2)
        ctx.save_for_backward(x, w1, b1, w2)
        return out

    @staticmethod
    def backward(ctx, dout):
        x, w1, b1, w2 = ctx.saved_tensors
        dx, dw1, db1, dw2, db2 = fused_mlp_bwd(
            x, dout.to(x.dtype).contiguous(), w1, b1, w2)
        return (dx, dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype),
                db2.to(b1.dtype))


def fused_mlp(x, w1, b1, w2, b2):
    """``fc2(gelu_tanh(fc1(x)))``, differentiable (K11a/K11b)."""
    return FusedMlp.apply(x.contiguous(), w1, b1, w2, b2)
