"""K2: the frozen teacher's fused MLP half, collecting into the layer stack.

Replaces ``basd_tpu/ops/pallas/fused_block_mlp.py:fused_ln_mlp_collect``
(``_fwd_collect_kernel``)::

    out = x + mask * fc2(gelu_tanh(fc1(LN2(x))))
    buf[idx*B*N:(idx+1)*B*N] = out          (in place)

The in-place write of the caller's flat (L*B*N, D) collection buffer takes
the place of the TPU kernel's ``input_output_aliases``. The CUDA kernel
(``csrc/block.cu``, ``basd_block_mlp_collect_fwd``) runs for a CUDA tensor;
``block_mlp_plain`` is the same function in plain PyTorch, taken for a CPU
tensor. Rounding follows the TPU kernel: LN output, fc1 output and GELU
output rounded to bf16, GELU in f32, fc2 output rounded to bf16, mask and
residual in f32, rounded once. Weights are in torch's (out, in) layout.
"""

from __future__ import annotations

import torch

from basd_tpu_torch.kernels import _build
from basd_tpu_torch.kernels.block_attn import _check, _mm, ln_bf16_plain

_GELU_C = 0.7978845608028654  # sqrt(2/pi)
_GELU_A = 0.044715


def gelu_tanh(p: torch.Tensor) -> torch.Tensor:
    """tanh-approximate GELU (``jax.nn.gelu(approximate=True)``)."""
    t = torch.tanh(_GELU_C * (p + _GELU_A * p * p * p))
    return 0.5 * p * (1.0 + t)


def block_mlp_plain(x, mask, ln_scale, ln_bias, w1, b1, w2, b2,
                    eps: float = 1e-6):
    b, n, d = x.shape
    xnb = ln_bf16_plain(x, ln_scale, ln_bias, eps)
    pre = (_mm(xnb, w1) + b1).to(x.dtype).float()
    h = gelu_tanh(pre).to(x.dtype)
    y = (_mm(h, w2) + b2).to(x.dtype).float()
    m = mask.float().reshape(b, 1, 1)
    return (x.float() + y * m).to(x.dtype)


def fused_ln_mlp_collect(x, mask, ln_scale, ln_bias, w1, b1, w2, b2,
                         buf, idx: int, eps: float = 1e-6):
    """Returns ``out`` (B, N, D) and writes it into rows
    ``[idx*B*N, (idx+1)*B*N)`` of ``buf`` (L*B*N, D) in place; other rows
    are untouched.

    x, buf: bf16; mask: (B,) f32 stochastic-depth multipliers (ones for the
    deterministic teacher); w1: (F, D), w2: (D, F) bf16; LN affine and
    biases f32.
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
    if x.device.type != "cuda":
        raise ValueError(f"fused_ln_mlp_collect: unsupported device {x.device}")
    f = w1.shape[0]
    if d % 8 or f % 8:
        raise ValueError(f"fused_ln_mlp_collect: D={d}, F={f} must be % 8")
    bf, f32 = torch.bfloat16, torch.float32
    _check("x", x, bf, (b, n, d))
    _check("mask", mask, f32, (b,))
    _check("w1", w1, bf, (f, d))
    _check("w2", w2, bf, (d, f))
    _check("buf", buf, bf, tuple(buf.shape))
    for name, t, size in (("ln_scale", ln_scale, d), ("ln_bias", ln_bias, d),
                          ("b1", b1, f), ("b2", b2, d)):
        _check(name, t, f32, (size,))
    for t in (mask, ln_scale, ln_bias, w1, b1, w2, b2, buf):
        if t.device != x.device:
            raise ValueError(
                "fused_ln_mlp_collect: all inputs must be on x's device"
            )
    out = torch.empty_like(x)
    ws_xn = torch.empty((m_rows, d), dtype=bf, device=x.device)
    ws_h = torch.empty((m_rows, f), dtype=bf, device=x.device)
    buf_rows = buf.data_ptr() + idx * m_rows * d * buf.element_size()
    _build.call(
        "basd_block_mlp_collect_fwd",
        x.data_ptr(), mask.data_ptr(), ln_scale.data_ptr(),
        ln_bias.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), out.data_ptr(), buf_rows, ws_xn.data_ptr(),
        ws_h.data_ptr(), b, n, d, f, float(eps), _build.stream_ptr(x.device),
    )
    fused_ln_mlp_collect.launches += 1
    return out


fused_ln_mlp_collect.launches = 0
