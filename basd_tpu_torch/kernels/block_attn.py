"""K1: the frozen teacher's fused attention half.

Replaces ``basd_tpu/ops/pallas/fused_block_attn.py:fused_block_attn``
(``_fwd_kernel``)::

    out = x + proj(MHSA(LN1(x) W_qkv + b_qkv))  (+ head-mean CLS-row importance)

The CUDA kernel (``csrc/block.cu``, ``basd_block_attn_fwd``) runs for a
CUDA tensor; ``block_attn_plain`` is the same function in plain PyTorch,
taken for a CPU tensor. Both round where the TPU kernel rounds: f32 LN
statistics, bf16 LN output, qkv accumulated in f32 and rounded to bf16,
per-head f32 softmax with bf16 probabilities into P.V and deferred
normalisation, proj accumulated in f32 and rounded to bf16, residual added
in f32 and rounded once. Weights are in torch's (out, in) layout.
Forward-only: the teacher is frozen.
"""

from __future__ import annotations

import torch

from basd_tpu_torch.kernels import _build

_SMEM_PER_BLOCK = 232448  # an H100 block's dynamic shared-memory limit


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16 operands, f32 accumulation: ``a @ w.T`` in f32."""
    return torch.matmul(a.float(), w.float().t())


def ln_bf16_plain(x, scale, bias, eps):
    """Two-pass f32 LayerNorm statistics, output rounded to x.dtype."""
    d = x.shape[-1]
    xf = x.float()
    mu = xf.sum(-1, keepdim=True) * (1.0 / d)
    xc = xf - mu
    var = (xc * xc).sum(-1, keepdim=True) * (1.0 / d)
    return ((xc * torch.rsqrt(var + eps)) * scale + bias).to(x.dtype)


def block_attn_plain(x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj,
                     num_heads: int, eps: float = 1e-6):
    b, n, d = x.shape
    e = d // num_heads
    scale = float(e) ** -0.5
    xnb = ln_bf16_plain(x, ln_scale, ln_bias, eps)
    qkv = (_mm(xnb, w_qkv) + b_qkv).to(x.dtype)
    q, k, v = (t.reshape(b, n, num_heads, e).transpose(1, 2)
               for t in qkv.split(d, dim=-1))  # (B, H, N, E)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.matmul(p.to(x.dtype).float(), v.float()) / l
    attn = o.to(x.dtype).transpose(1, 2).reshape(b, n, d)
    row0 = p[:, :, 0, :] / (l[:, :, 0] * num_heads)  # (B, H, N)
    imp = row0[:, 0]
    for i in range(1, num_heads):
        imp = imp + row0[:, i]
    y = (_mm(attn, w_proj) + b_proj).to(x.dtype).float()
    return (x.float() + y).to(x.dtype), imp


def _check(name, t, dtype, shape):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name}: expected {dtype} {tuple(shape)}, got {t.dtype} "
            f"{tuple(t.shape)}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def fused_block_attn(x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj,
                     num_heads: int, eps: float = 1e-6):
    """Returns ``(out (B, N, D) in x.dtype, importance (B, N) f32)``; the
    importance includes the CLS key at index 0 (the caller strips it).

    x: (B, N, D) bf16; ln_scale, ln_bias, b_qkv, b_proj: f32;
    w_qkv: (3D, D), w_proj: (D, D) bf16.
    """
    if x.device.type == "cpu":
        return block_attn_plain(x, ln_scale, ln_bias, w_qkv, b_qkv, w_proj,
                                b_proj, num_heads, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_block_attn: unsupported device {x.device}")
    b, n, d = x.shape
    if d % num_heads or (d // num_heads) % 2 or d % 8:
        raise ValueError(
            f"fused_block_attn: D={d} with {num_heads} heads needs an even "
            f"head width and D % 8 == 0"
        )
    e = d // num_heads
    # one (image, head) block keeps K, V and a score row per warp on chip
    smem = n * (e + 2) * 2 + n * e * 2 + 8 * (n + e) * 4
    if smem > _SMEM_PER_BLOCK:
        raise ValueError(
            f"fused_block_attn: N={n}, head width {e} needs {smem} bytes of "
            f"shared memory per block, more than {_SMEM_PER_BLOCK}"
        )
    bf, f32 = torch.bfloat16, torch.float32
    _check("x", x, bf, (b, n, d))
    _check("w_qkv", w_qkv, bf, (3 * d, d))
    _check("w_proj", w_proj, bf, (d, d))
    for name, t, size in (("ln_scale", ln_scale, d), ("ln_bias", ln_bias, d),
                          ("b_qkv", b_qkv, 3 * d), ("b_proj", b_proj, d)):
        _check(name, t, f32, (size,))
    for t in (ln_scale, ln_bias, w_qkv, b_qkv, w_proj, b_proj):
        if t.device != x.device:
            raise ValueError("fused_block_attn: all inputs must be on x's device")
    out = torch.empty_like(x)
    imp = torch.empty((b, n), dtype=f32, device=x.device)
    ws_xn = torch.empty((b * n, d), dtype=bf, device=x.device)
    ws_qkv = torch.empty((b * n, 3 * d), dtype=bf, device=x.device)
    ws_imp = torch.empty((b, num_heads, n), dtype=f32, device=x.device)
    _build.call(
        "basd_block_attn_fwd",
        x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
        w_qkv.data_ptr(), b_qkv.data_ptr(), w_proj.data_ptr(),
        b_proj.data_ptr(), out.data_ptr(), imp.data_ptr(), ws_xn.data_ptr(),
        ws_qkv.data_ptr(), ws_imp.data_ptr(), b, n, d, num_heads,
        float(eps), float(e) ** -0.5, _build.stream_ptr(x.device),
    )
    fused_block_attn.launches += 1
    return out, imp


fused_block_attn.launches = 0
