"""K11: the fused MLP ``fc2(gelu_tanh(fc1(x)))``, the ``fused`` MLP impl.

Replaces ``basd_tpu/ops/pallas/fused_mlp.py:fused_mlp``: K11a
``fused_mlp_fwd`` (``_fwd``) and K11b ``fused_mlp_bwd`` (``_bwd``), the
recompute VJP returning dx and the f32 gradients dw1, db1, dw2, db2 summed
over the rows. ``FusedMlp`` wraps them as a ``torch.autograd.Function``
that saves only x and the weights; as the JAX package's VJP it returns the
weight gradients in the weights' dtype and both bias gradients in b1's.

The CUDA kernels (``csrc/fused_mlp.cu``) run for bf16 CUDA tensors (the
wgmma GEMM of ``csrc/gemm_sm90.cuh`` where its rule allows; K11b counts
its four backward products by variant in ``gemm_variants``) and f32 CUDA
tensors (CUDA-core f32 GEMMs with the same epilogues, full f32, no TF32)
and raise on any other CUDA dtype; the
``*_plain`` functions are the same arithmetic in plain PyTorch, taken for
CPU tensors of any float dtype.
Rounding follows the TPU kernel: operands in x's dtype, f32 accumulation,
the pre-activation rounded to x's dtype before an f32 tanh-GELU (tanh at
every dtype: the fused MLP never takes erf), the hidden state rounded into
fc2, ``out = (acc + b2)`` rounded once; the backward's points are listed at
``fused_mlp_plain_bwd``. Weights are in torch's (out, in) layout, the
transpose of the JAX kernel's (in, out).

Tensor parallelism (``parallel.mesh.ModelParallel``): a rank holds F of the
hidden units. ``fused_mlp_fwd_partial`` (K11a with ``partial`` set) returns
the f32 sums of fc2 over them without b2; ``fused_mlp_bwd_partial`` (K11b)
the f32 input gradient without rounding, db2 left to the caller; each
counts its own launches. ``FusedMlpPartial`` wraps them for the module
chain, which sums the shares over the model group and adds b2 once.
"""

from __future__ import annotations

import torch

from basd_tpu_torch.kernels import _build
from basd_tpu_torch.kernels.block_attn import _ROW_CHUNK, _check, _mm
from basd_tpu_torch.kernels.block_mlp import gelu_tanh, gelu_tanh_grad
from basd_tpu_torch.kernels.gemm import (
    count_products,
    gemm_bwd_variant,
    gemm_tile_m,
    weight_grad_floats,
)


def fused_mlp_plain_fwd(x, w1, b1, w2, b2):
    """(B, N, Do) in x.dtype; w1 (F, D), w2 (Do, F); ``b2`` None: the f32
    sums of fc2 alone (a tensor-parallel rank's share)."""
    dt = x.dtype
    pre = (_mm(x, w1) + b1.float()).to(dt).float()
    h = gelu_tanh(pre).to(dt)
    if b2 is None:
        return _mm(h, w2)
    return (_mm(h, w2) + b2.float()).to(dt)


def fused_mlp_plain_bwd(x, dout, w1, b1, w2, partial: bool = False):
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
    dx = torch.matmul(dpreb, w1.float())
    if not partial:  # a tensor-parallel share stays f32
        dx = dx.to(dt)
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
    _check_mlp("fused_mlp_fwd", x, w1, b1, w2,
               ("b2", b2, torch.float32, (w2.shape[0],)))
    return _fwd_call(fused_mlp_fwd, x, w1, b1, w2, b2)


def _fwd_call(fn, x, w1, b1, w2, b2):
    """K11a's entry on checked inputs (``b2`` None: the partial mode, f32
    out); counts the launch on ``fn``."""
    m, f, do_ = x.shape[0] * x.shape[1], w1.shape[0], w2.shape[0]
    dt = x.dtype if b2 is not None else torch.float32
    out = torch.empty(x.shape[:-1] + (do_,), dtype=dt, device=x.device)
    ws_h = torch.empty((m, f), dtype=x.dtype, device=x.device)
    _build.call(_build.entry("basd_fused_mlp_fwd", x.dtype), x.data_ptr(),
                w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                0 if b2 is None else b2.data_ptr(), out.data_ptr(),
                ws_h.data_ptr(), m, x.shape[-1], f, do_, int(b2 is None),
                _build.stream_ptr(x.device))
    fn.launches += 1
    return out


def fused_mlp_fwd_partial(x, w1, b1, w2):
    """K11a's share on a tensor-parallel rank of F (>= 1) hidden units: the
    f32 sums of fc2, (B, N, Do), no b2."""
    if x.device.type == "cpu":
        return fused_mlp_plain_fwd(x, w1, b1, w2, None)
    _check_mlp("fused_mlp_fwd_partial", x, w1, b1, w2)
    return _fwd_call(fused_mlp_fwd_partial, x, w1, b1, w2, None)


def fused_mlp_bwd(x, dout, w1, b1, w2):
    """K11b: ``(dx in x's dtype, dw1, db1, dw2, db2)``, the gradients f32
    and summed over the rows."""
    if x.device.type == "cpu":
        return fused_mlp_plain_bwd(x, dout, w1, b1, w2)
    _check_mlp("fused_mlp_bwd", x, w1, b1, w2,
               ("dout", dout, x.dtype, x.shape[:-1] + (w2.shape[0],)))
    return _bwd_call(fused_mlp_bwd, x, dout, w1, b1, w2, False)


def fused_mlp_bwd_partial(x, dout, w1, b1, w2):
    """K11b's share on a tensor-parallel rank of F (>= 1) hidden units:
    ``(dx f32, dw1, db1, dw2)``, dx = dpre W1 unrounded; db2 is the
    caller's."""
    if x.device.type == "cpu":
        return fused_mlp_plain_bwd(x, dout, w1, b1, w2, partial=True)[:4]
    _check_mlp("fused_mlp_bwd_partial", x, w1, b1, w2,
               ("dout", dout, x.dtype, x.shape[:-1] + (w2.shape[0],)))
    return _bwd_call(fused_mlp_bwd_partial, x, dout, w1, b1, w2, True)[:4]


def _bwd_call(fn, x, dout, w1, b1, w2, partial):
    """K11b's entry on checked inputs (``partial``: f32 dx, no db2);
    counts the launch and its products on ``fn``."""
    m, d, f, do_ = x.shape[0] * x.shape[1], x.shape[-1], w1.shape[0], w2.shape[0]
    dev = x.device
    f32 = torch.float32
    chunks = -(-m // _ROW_CHUNK)
    dx = (torch.empty(x.shape, dtype=f32, device=dev) if partial
          else torch.empty_like(x))
    dw1 = torch.empty((f, d), dtype=f32, device=dev)
    db1 = torch.empty((f,), dtype=f32, device=dev)
    dw2 = torch.empty((do_, f), dtype=f32, device=dev)
    db2 = torch.empty((do_,), dtype=f32, device=dev)
    ws_pre, ws_h, ws_dpre = (torch.empty((m, f), dtype=x.dtype, device=dev)
                             for _ in range(3))
    # one column-sum row per row tile of the GELU-gradient product
    dgelu = gemm_bwd_variant(x.dtype, (do_, f), [t.data_ptr() for t in
                                                 (dout, w2, ws_dpre, ws_pre)])
    ws_part = torch.empty(
        (max(weight_grad_floats(m, ((do_, f), (f, d))),
             -(-m // gemm_tile_m(dgelu)) * f, chunks * do_),),
        dtype=f32, device=dev)
    _build.call(
        _build.entry("basd_fused_mlp_bwd", x.dtype), x.data_ptr(),
        dout.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), dx.data_ptr(), dw1.data_ptr(),
        db1.data_ptr(), dw2.data_ptr(), db2.data_ptr(), ws_pre.data_ptr(),
        ws_h.data_ptr(), ws_dpre.data_ptr(), ws_part.data_ptr(), m, d, f, do_,
        _ROW_CHUNK, int(partial), _build.stream_ptr(dev),
    )
    fn.launches += 1
    # dW2 = do^T h, dpre = (do W2) gelu'(pre), dW1 = dpre^T x, dx = dpre W1
    # (csrc/fused_mlp.cu)
    count_products(fn, x.dtype, (
        ((do_, f), (dout, ws_h, ws_part)),
        ((do_, f), (dout, w2, ws_dpre, ws_part, ws_pre)),
        ((f, d), (ws_dpre, x, ws_part)),
        ((f, d), (ws_dpre, w1, dx))))
    return dx, dw1, db1, dw2, db2


for _fn in (fused_mlp_fwd, fused_mlp_bwd, fused_mlp_fwd_partial,
            fused_mlp_bwd_partial):
    _fn.launches = 0
# backward products by GEMM variant (gemm.gemm_bwd_variant), four a launch
fused_mlp_bwd.gemm_variants = {"sm90": 0, "wmma": 0, "f32": 0}
fused_mlp_bwd_partial.gemm_variants = {"sm90": 0, "wmma": 0, "f32": 0}


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


class FusedMlpPartial(torch.autograd.Function):
    """A tensor-parallel rank's share of the fused MLP: K11a's f32 sums
    forward, K11b's backward. ``x`` comes in f32 (the model group's
    ``copy_in`` sums its gradient in f32) holding values of ``dtype``, which
    the kernels take; its gradient goes back in f32, unrounded."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, dtype):
        xd = x.to(dtype)
        ctx.save_for_backward(xd, w1, b1, w2)
        return fused_mlp_fwd_partial(xd, w1, b1, w2)

    @staticmethod
    def backward(ctx, dout):
        xd, w1, b1, w2 = ctx.saved_tensors
        dx, dw1, db1, dw2 = fused_mlp_bwd_partial(
            xd, dout.to(xd.dtype).contiguous(), w1, b1, w2)
        return (dx.float(), dw1.to(w1.dtype), db1.to(b1.dtype),
                dw2.to(w2.dtype), None)


def fused_mlp_partial(x, w1, b1, w2, dtype):
    """``fc2(gelu_tanh(fc1(x)))``'s f32 sums without b2 on a tensor-parallel
    rank, differentiable (``FusedMlpPartial``)."""
    return FusedMlpPartial.apply(x.contiguous(), w1, b1, w2, dtype)
