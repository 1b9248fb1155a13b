"""K10: attention over the packed qkv slab, the ``flash`` attention impl.

Replaces ``basd_tpu/ops/pallas/flash_attention.py``. The kernels consume the
(B, N, 3D) slab exactly as the ``qkv`` Linear produces it (head i: q at
columns ``[i*E, (i+1)*E)``, k at ``D + i*E``, v at ``2*D + i*E``):

- K10a ``flash_attention_fwd`` (``_fwd``): ``o = softmax(scale q k^T) v``
  (B, N, D) and the per-(image, head, query) logsumexp (B, H, N) f32;
- K10b ``flash_attention_bwd`` (``_bwd``): dqkv from qkv, the saved o, do
  and lse;
- K10c ``flash_attention_imp`` (``_fwd_hp``, and ``_fwd`` with importance
  for an odd head count): o and the head-mean CLS-query softmax row (B, N)
  f32, CLS key included (the caller strips it). Forward only.

``FlashAttention`` (K10a forward saving qkv, o and lse; K10b backward) and
``FlashAttentionImportance`` (K10c; its backward raises, as the JAX
package's does) are the ``torch.autograd.Function`` s behind
``flash_attention_qkv`` and ``flash_attention_qkv_with_importance``. The
forward reaches K10a through the operator ``basd_tpu_torch::flash_attention_fwd``
(``torch.library``), so that selective checkpointing sees its call and can
keep its outputs (``models.vit``, ``remat_policy='dots'``); a pybind or
ctypes call is invisible to it.

The CUDA kernels (``csrc/flash_attention.cu``) run for bf16 and f32 CUDA
tensors and raise on any other CUDA dtype; the ``*_plain`` functions are
the same arithmetic in plain PyTorch, taken for CPU tensors of any float
dtype. Both round where the TPU kernels round: f32 scores and softmax,
probabilities in qkv's dtype into P.V with deferred normalisation, o in
qkv's dtype; the backward's points are listed at
``flash_attention_plain_bwd``. The forward (K10a, K10c) is the attention
core of ``csrc/attention.cuh``: a bf16 slab whose head width E is a
multiple of 16 in [16, 128] takes its tensor-core kernel, an f32 slab or
any other even E its CUDA-core kernel (``block_attn.attn_fwd_variant``;
each wrapper counts them in ``tc_launches`` and ``simt_launches``). The
backward (K10b) is the backward core of ``csrc/attention_bwd.cuh``, which
K3b shares, with the same rule (``block_attn.attn_bwd_variant``): on
tensor cores, tiled over 64-query and 64-key blocks, its shared memory
does not grow with N; on CUDA cores (f32, other even E) each of its two
launches holds two of q, k, v and do of one (image, head), ~159 KB at f32,
N=257, E=64 (``block_attn._attn_bwd_smem``). The plain
importance follows the TPU kernel the head count selects: for an even
count the head-pair kernel (rows pre-divided by l * H, added pair by pair),
for an odd one the head-loop kernel (rows over l summed, then over H).
"""

from __future__ import annotations

import torch

from basd_tpu_torch.kernels import _build
from basd_tpu_torch.kernels.block_attn import (
    _attn_bwd_variant_checked,
    _attn_fwd_variant_checked,
    _check,
    _count_attn_launch,
    _heads,
    _merge_heads,
)

_DTYPES = (torch.bfloat16, torch.float32)  # the types the kernels take

_IMP_BACKWARD = (
    "flash_attention_qkv_with_importance is forward-only "
    "(frozen-teacher extraction). For gradients through a "
    "cls-importance attention use attention_impl='einsum'."
)


def _slab_heads(qkv: torch.Tensor, num_heads: int):
    """(B, N, 3D) slab -> q, k, v, each (B, H, N, E) in f32."""
    return tuple(_heads(t, num_heads).float()
                 for t in qkv.split(qkv.shape[-1] // 3, dim=-1))


def _attention_plain(qkv, num_heads: int, scale: float):
    """o (B, N, D) in qkv.dtype, unnormalised p, row max m and row sum l
    (the last three f32 (B, H, N, N | 1))."""
    q, k, v = _slab_heads(qkv, num_heads)
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.matmul(p.to(qkv.dtype).float(), v) / l
    return _merge_heads(o.to(qkv.dtype)), p, m, l


def flash_attention_plain_fwd(qkv, num_heads: int, scale: float):
    """``(o (B, N, D) in qkv.dtype, lse (B, H, N) f32)``."""
    o, _, m, l = _attention_plain(qkv, num_heads, scale)
    return o, (m + torch.log(l))[..., 0]


def flash_attention_plain_imp(qkv, num_heads: int, scale: float):
    """``(o, importance (B, N) f32)``, rounded as the TPU kernel that the
    head count selects (module docstring)."""
    o, p, _, l = _attention_plain(qkv, num_heads, scale)
    h = num_heads
    if h % 2 == 0:  # _fwd_kernel_hp: pre-divided rows, pair sums in order
        row0 = p[:, :, 0, :] / (l[:, :, 0] * h)
        imp = row0[:, 0] + row0[:, 1]
        for j in range(2, h, 2):
            imp = imp + (row0[:, j] + row0[:, j + 1])
    else:  # _fwd_kernel with importance: rows over l, summed, then over h
        row0 = p[:, :, 0, :] / l[:, :, 0]
        imp = row0[:, 0]
        for i in range(1, h):
            imp = imp + row0[:, i]
        imp = imp / h
    return o, imp


def flash_attention_plain_bwd(qkv, o, dout, lse, num_heads: int, scale: float):
    """Recompute backward of K10 (``flash_attention.py:81-124``): dqkv
    (B, N, 3D) in qkv.dtype. ``dout`` is already in qkv's dtype. Rounding
    points: p = exp(s - lse) f32; dv = p^T do with p in qkv's dtype;
    dp = do v^T and delta = sum(do * o) in f32; ds = p (dp - delta) scale
    rounded to qkv's dtype; dq = ds k, dk = ds^T q in f32, every output
    rounded once."""
    dt = qkv.dtype
    q, k, v = _slab_heads(qkv, num_heads)
    of, dof = _heads(o, num_heads).float(), _heads(dout, num_heads).float()
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    p = torch.exp(s - lse[..., None])
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), dof)
    dp = torch.matmul(dof, v.transpose(-1, -2))
    delta = (dof * of).sum(-1, keepdim=True)
    ds = (p * (dp - delta) * scale).to(dt).float()
    dq = torch.matmul(ds, k)
    dk = torch.matmul(ds.transpose(-1, -2), q)
    return torch.cat([_merge_heads(t.to(dt)) for t in (dq, dk, dv)], -1)


def _slab_dims(name, qkv, num_heads, others=()):
    """Type and shape rules of the CUDA path, on any device: qkv (B, N, 3D)
    bf16 or f32 with an even head width; ``others``: further (name,
    tensor, dtype, shape) inputs. Returns (B, N, D, E)."""
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"{name}: qkv must be (B, N, 3D), got "
                         f"{tuple(qkv.shape)}")
    if qkv.dtype not in _DTYPES:
        raise ValueError(f"{name}: qkv must be bf16 or f32, got {qkv.dtype}")
    b, n, d3 = qkv.shape
    d = d3 // 3
    if d % num_heads or (d // num_heads) % 2:
        raise ValueError(f"{name}: D={d} with {num_heads} heads needs an "
                         f"even head width")
    _check("qkv", qkv, qkv.dtype, (b, n, d3))
    for pname, t, dtype, shape in others:
        _check(pname, t, dtype, shape)
        if t.device != qkv.device:
            raise ValueError(f"{name}: all inputs must be on qkv's device")
    return b, n, d, d // num_heads


def _check_slab(name, qkv, num_heads, others=()):
    """``_slab_dims`` for a CUDA tensor; raises on any other device."""
    if qkv.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {qkv.device}")
    return _slab_dims(name, qkv, num_heads, others)


def flash_attention_fwd(qkv, num_heads: int, scale: float):
    """K10a: ``(o (B, N, D), lse (B, H, N) f32)`` of a (B, N, 3D) slab; on
    CUDA the tensor-core kernel for bf16 with E % 16 == 0 in [16, 128], the
    CUDA-core kernel for f32 or another even E."""
    if qkv.device.type == "cpu":
        return flash_attention_plain_fwd(qkv, num_heads, scale)
    b, n, d, e = _check_slab("flash_attention_fwd", qkv, num_heads)
    variant = _attn_fwd_variant_checked("flash_attention_fwd", qkv.dtype, n,
                                        e, qkv.data_ptr())
    o = torch.empty((b, n, d), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((b, num_heads, n), dtype=torch.float32,
                      device=qkv.device)
    _build.call(_build.entry("basd_flash_attn_fwd", qkv.dtype),
                qkv.data_ptr(), o.data_ptr(), lse.data_ptr(), b, n, d,
                num_heads, float(scale), _build.stream_ptr(qkv.device))
    _count_attn_launch(flash_attention_fwd, variant)
    return o, lse


def flash_attention_imp(qkv, num_heads: int, scale: float):
    """K10c: ``(o (B, N, D), importance (B, N) f32)``, CLS key included;
    the kernels as K10a's."""
    if qkv.device.type == "cpu":
        return flash_attention_plain_imp(qkv, num_heads, scale)
    b, n, d, e = _check_slab("flash_attention_imp", qkv, num_heads)
    variant = _attn_fwd_variant_checked("flash_attention_imp", qkv.dtype, n,
                                        e, qkv.data_ptr())
    dev = qkv.device
    o = torch.empty((b, n, d), dtype=qkv.dtype, device=dev)
    imp = torch.empty((b, n), dtype=torch.float32, device=dev)
    ws_imp = torch.empty((b, num_heads, n), dtype=torch.float32, device=dev)
    _build.call(_build.entry("basd_flash_attn_imp", qkv.dtype),
                qkv.data_ptr(), o.data_ptr(), imp.data_ptr(),
                ws_imp.data_ptr(), b, n, d, num_heads, float(scale),
                _build.stream_ptr(dev))
    _count_attn_launch(flash_attention_imp, variant)
    return o, imp


def flash_attention_bwd(qkv, o, dout, lse, num_heads: int, scale: float):
    """K10b: dqkv (B, N, 3D) in qkv's dtype; ``dout`` in qkv's dtype. On
    CUDA the tensor-core kernels for bf16 with E % 16 == 0 in [16, 128],
    the CUDA-core ones for f32 or another even E (two launches each)."""
    if qkv.device.type == "cpu":
        return flash_attention_plain_bwd(qkv, o, dout, lse, num_heads, scale)
    b, n = qkv.shape[:2]
    d = qkv.shape[-1] // 3
    _, _, _, e = _check_slab(
        "flash_attention_bwd", qkv, num_heads,
        [("o", o, qkv.dtype, (b, n, d)), ("dout", dout, qkv.dtype, (b, n, d)),
         ("lse", lse, torch.float32, (b, num_heads, n))])
    variant = _attn_bwd_variant_checked("flash_attention_bwd", qkv.dtype, n,
                                        e, (qkv.data_ptr(), dout.data_ptr()))
    dqkv = torch.empty_like(qkv)
    ws_delta = torch.empty((b, num_heads, n), dtype=torch.float32,
                           device=qkv.device)
    _build.call(_build.entry("basd_flash_attn_bwd", qkv.dtype),
                qkv.data_ptr(), o.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                dqkv.data_ptr(), ws_delta.data_ptr(), b, n, d, num_heads,
                float(scale), _build.stream_ptr(qkv.device))
    _count_attn_launch(flash_attention_bwd, variant)
    return dqkv


flash_attention_fwd.launches = 0
flash_attention_bwd.launches = 0
flash_attention_imp.launches = 0
for _fn in (flash_attention_fwd, flash_attention_imp, flash_attention_bwd):
    _fn.tc_launches = _fn.simt_launches = 0


@torch.library.custom_op("basd_tpu_torch::flash_attention_fwd", mutates_args=())
def flash_attention_fwd_op(qkv: torch.Tensor, num_heads: int,
                           scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """``flash_attention_fwd`` as a dispatcher operator."""
    return flash_attention_fwd(qkv, num_heads, scale)


class FlashAttention(torch.autograd.Function):
    """K10a forward (saves qkv, o and lse), K10b backward."""

    @staticmethod
    def forward(ctx, qkv, num_heads, scale):
        o, lse = flash_attention_fwd_op(qkv, num_heads, scale)
        ctx.save_for_backward(qkv, o, lse)
        ctx.num_heads, ctx.scale = num_heads, scale
        return o

    @staticmethod
    def backward(ctx, dout):
        qkv, o, lse = ctx.saved_tensors
        dqkv = flash_attention_bwd(qkv, o, dout.to(qkv.dtype).contiguous(),
                                   lse, ctx.num_heads, ctx.scale)
        return dqkv, None, None


class FlashAttentionImportance(torch.autograd.Function):
    """K10c; forward-only, as ``flash_attention.py:345-350``."""

    @staticmethod
    def forward(ctx, qkv, num_heads, scale):
        return flash_attention_imp(qkv, num_heads, scale)

    @staticmethod
    def backward(ctx, dout, dimp):
        raise NotImplementedError(_IMP_BACKWARD)


def flash_attention_qkv(qkv, num_heads: int, scale: float):
    """Attention output (B, N, D) of the packed slab, differentiable."""
    return FlashAttention.apply(qkv.contiguous(), num_heads, float(scale))


def flash_attention_qkv_with_importance(qkv, num_heads: int, scale: float):
    """``(o, importance (B, N))``, CLS key included; forward-only."""
    return FlashAttentionImportance.apply(qkv.contiguous(), num_heads,
                                          float(scale))
