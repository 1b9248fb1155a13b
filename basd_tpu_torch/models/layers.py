"""ViT building blocks (counterpart of ``basd_tpu/models/layers.py``).

Parameters are f32 and keep timm's names and (out, in) layouts; a module's
``dtype`` is its compute dtype (parameters are cast at use, as flax's
``Dense(dtype=...)`` does). Numerics follow the reference: bf16 paths use
tanh-GELU and f32 paths use erf; LayerNorm statistics are f32.

Block dispatch, restated for CUDA from ``layers.py:392-562``: where the
JAX package asks ``jax.default_backend() == "tpu"``, the port asks whether
the activations lie on a CUDA device. With ``attention_impl='auto'`` a
bf16 block on CUDA takes, for its attention half, K1
(``kernels.block_attn.fused_block_attn``) when it is the frozen teacher's
(``importance_mode='cls'``, no stochastic depth) and K3
(``fused_block_attn_train``) when it is the student's
(``importance_mode=None``); with ``mlp_impl='auto'`` it takes, for its MLP
half, K2 (``kernels.block_mlp.fused_ln_mlp_collect``) when a collection
buffer is given and K4 (``fused_ln_mlp``) otherwise; a SwiGLU MLP
(``Mlp(kind='swiglu')``, a DINOv2 ViT-g/14 teacher's) takes K2g
(``fused_ln_swiglu_collect``, forward only) with or without the buffer, and
the module chain under autograd. With the program tracer on, the MLP half
of a block that writes the collection stack is the span ``teacher_mlp``.
Off CUDA, ``auto`` takes the module chain, as the JAX package does off the
TPU. An explicit
``fused_block`` / ``fused_block_train`` / ``fused_ln`` forces the kernel
path (on a CPU tensor, its plain version); ``module`` forces the module
chain, whose LayerNorms keep their own ``auto`` (K5 on CUDA). An explicit
``fused_ln`` on an f32 block takes K2 / K4's f32 entries on CUDA (tanh-GELU,
full-f32 GEMMs, as the reference's f32 Pallas kernel) and their plain
version on the CPU, in the block's dtype, as the reference's Pallas kernel
runs in interpret mode; ``auto`` at f32 takes the module chain, as the
reference's does.

Inside the module chain (``layers.py:140-290``), ``Attention`` takes
``attention_impl``: ``flash`` runs K10 on the packed qkv slab
(``kernels.flash_attention``; with ``importance_mode='cls'`` the forward-only
importance variant), ``einsum`` the plain attention, and ``auto`` K10 on
CUDA at any dtype and einsum otherwise (``attention_auto_impl``, as
``layers.py:247-251`` picks flash on the TPU); ``importance_mode='mean'`` always
takes einsum, which it needs the full probabilities for. ``Mlp`` takes
``mlp_impl``: ``fused`` runs K11 (``kernels.fused_mlp``, tanh-GELU at every
dtype), ``dense`` the Linear chain, ``auto`` K11 for a bf16 3-D input on
CUDA and dense otherwise. ``Block`` hands ``flash`` / ``fused`` / ``auto``
through and maps ``module`` to ``einsum`` / ``dense``, as
``layers.py:481-483`` and ``553-555`` do. On a CPU tensor every kernel
wrapper takes its plain version.

Tensor parallelism (``parallel.mesh.ModelParallel``, ``Block.set_tp``): a
block on a rank of a model group holds its heads' qkv rows and proj
columns and its hidden units' fc1 rows and fc2 columns. Each half computes
its share of the row-parallel product in f32 without bias, sums the shares
over the group, then adds bias, LayerScale, mask and residual once, so the
rounding points of the one-rank block survive: the fused halves through
``block_attn.fused_block_attn_tp`` (K1), ``FusedBlockAttnTrainTP`` (K3),
``block_mlp.fused_ln_mlp_collect_tp`` (K2) and ``FusedLnMlpTP`` (K4), which
sum in place inside (forward: the share; backward: dxln with the LN
gradients); the module chain through ``copy_in`` on the normalised input
(f32), ``Attention.share`` / ``Mlp.share`` (K10 on the rank's heads, K11's
partial entry) and ``reduce``. The CLS importance is each rank's heads'
rows over the block's head count, summed the same way. Under remat the
recompute runs a half's forward sum again; the backward's sums are
``copy_in``'s (module chain) or the fused Functions' own. ``tp`` None (one
process, or ``model: 1``) runs the code above unchanged.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from basd_tpu_torch.kernels.block_attn import (
    fused_block_attn,
    fused_block_attn_tp,
    fused_block_attn_train,
    fused_block_attn_train_tp,
)
from basd_tpu_torch.kernels.block_mlp import (
    fused_ln_mlp,
    fused_ln_mlp_collect,
    fused_ln_mlp_collect_tp,
    fused_ln_mlp_tp,
    fused_ln_swiglu_collect,
)
from basd_tpu_torch.kernels.flash_attention import (
    flash_attention_qkv,
    flash_attention_qkv_with_importance,
)
from basd_tpu_torch.kernels.fused_mlp import fused_mlp, fused_mlp_partial
from basd_tpu_torch.kernels.layernorm import fused_layernorm
from basd_tpu_torch.utils import trace


_UNKEPT = threading.local()


@contextlib.contextmanager
def unkept_products():
    """Products made inside are not kept by ``remat_policy='dots'``
    (``vit.dots_policy``) but recomputed: those inside a kernel, whose
    products are its own, as a Pallas call's are to the JAX package's
    policy, and the MLP's fc2, whose output only an add reads (a LayerScale
    after it would, which no student has), so the JAX package's partial
    evaluation drops it."""
    before = getattr(_UNKEPT, "on", False)
    _UNKEPT.on = True
    try:
        yield
    finally:
        _UNKEPT.on = before


def products_unkept() -> bool:
    return getattr(_UNKEPT, "on", False)


def drop_path(x: torch.Tensor, keep_mask: torch.Tensor, keep: float):
    """Per-sample stochastic depth (timm scale-by-keep): ``keep_mask`` is a
    (B,) bool draw, ``keep = 1 - rate``."""
    m = keep_mask.reshape((-1,) + (1,) * (x.dim() - 1))
    return torch.where(m, x / keep, torch.zeros((), dtype=x.dtype,
                                                device=x.device)).to(x.dtype)


def attention_auto_impl(is_cuda: bool) -> str:
    """What ``Attention``'s ``attention_impl='auto'`` takes: K10
    (``'flash'``) on CUDA at any dtype, as the reference takes it on the
    TPU (``layers.py:247-251``), ``'einsum'`` elsewhere."""
    return "flash" if is_cuda else "einsum"


def block_mlp_path(impl: str, is_cuda: bool, dtype: torch.dtype,
                   ndim: int, kind: str = "gelu") -> str:
    """``Block``'s MLP dispatch (``layers.py:503-517``): 'fused_ln' (K2 /
    K4, or K2g for a SwiGLU MLP) or the module chain. ``auto`` takes the
    kernels for a bf16 3-D block on CUDA; an explicit ``fused_ln`` takes
    K2 / K4 at bf16 and f32 (their ``_f32`` entries, tanh-GELU as the
    reference's f32 ``fused_ln``) on either device, and K2g, which is bf16
    only, at bf16 (its plain version on the CPU); a SwiGLU MLP at any other
    dtype or rank takes the module chain."""
    bf16_3d = ndim == 3 and dtype == torch.bfloat16
    if impl == "auto" and is_cuda and bf16_3d:
        impl = "fused_ln"
    if kind == "swiglu" and impl == "fused_ln" and not bf16_3d:
        impl = "auto"
    return impl


class Linear(nn.Linear):
    """``nn.Linear`` with f32 parameters computing in ``dtype``."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class LayerNorm(nn.Module):
    """LayerNorm with f32 statistics, output in ``dtype`` (the JAX
    package's ``FusedLayerNorm`` with its default ``impl='auto'``): K5
    (``kernels.layernorm.fused_layernorm``, two-pass variance) for a 3-D
    input on CUDA, flax's math (fast variance, f32 affine) otherwise."""

    def __init__(self, dim: int, eps: float = 1e-6,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps
        self.compute_dtype = dtype

    def forward(self, x):
        if x.is_cuda and x.dim() == 3:
            return fused_layernorm(x.to(self.compute_dtype), self.weight.float(),
                                   self.bias.float(), self.eps
                                   ).to(self.compute_dtype)
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        mu2 = (xf * xf).mean(-1, keepdim=True)
        var = torch.clamp(mu2 - mu * mu, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        y = (xf - mu) * mul + self.bias.float()
        return y.to(self.compute_dtype)


class LayerScale(nn.Module):
    def __init__(self, dim: int, init_value: float):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init_value)))

    def forward(self, x):
        return x * self.gamma.to(x.dtype)


class Mlp(nn.Module):
    """``kind`` 'gelu': fc2(gelu(fc1(x))); 'swiglu' (DINOv2's
    ``SwiGLUFFN``, timm's ``SwiGLUPacked``): fc1 (2 hidden, dim) packed
    [a | g], fc2(silu(a) * g), always on the Linear chain (K11 is GELU's)."""

    def __init__(self, dim: int, hidden_dim: int,
                 dtype: torch.dtype = torch.float32, mlp_impl: str = "auto",
                 kind: str = "gelu"):
        super().__init__()
        if kind not in ("gelu", "swiglu"):
            raise ValueError(f"unknown MLP kind {kind!r}")
        self.kind = kind
        self.fc1 = Linear(dim, hidden_dim * (2 if kind == "swiglu" else 1),
                          dtype)
        self.fc2 = Linear(hidden_dim, dim, dtype)
        self.compute_dtype = dtype
        self.mlp_impl = mlp_impl

    def _impl(self, x, impl):
        impl = impl or self.mlp_impl
        if self.kind == "swiglu":
            return "dense"
        if impl == "auto":
            impl = ("fused" if x.is_cuda and self.compute_dtype == torch.bfloat16
                    and x.dim() == 3 else "dense")
        return impl

    def _act(self, u):
        if self.kind == "swiglu":
            a, g = u.chunk(2, dim=-1)
            return F.silu(a) * g
        approx = "tanh" if self.compute_dtype == torch.bfloat16 else "none"
        return F.gelu(u, approximate=approx)

    def share(self, x32, tp, impl: Optional[str] = None):
        """A tensor-parallel rank's share: the f32 sums of fc2 over its
        hidden units, no bias, from ``x32`` (the normalised input in f32,
        after ``copy_in``); zeros for a rank without units."""
        dt = self.compute_dtype
        if not self.fc1.out_features:
            return tp.zero_share(x32, x32.shape)
        if self._impl(x32, impl) == "fused":
            with unkept_products():
                return fused_mlp_partial(x32, self.fc1.weight.to(dt),
                                         self.fc1.bias, self.fc2.weight.to(dt),
                                         dt)
        h = self._act(self.fc1(x32))
        with unkept_products():
            return torch.matmul(h.float(), self.fc2.weight.float().t())

    def forward(self, x, impl: Optional[str] = None):
        """``impl``: overrides ``mlp_impl`` for this call."""
        dt = self.compute_dtype
        impl = self._impl(x, impl)
        if impl == "fused":
            with unkept_products():
                return fused_mlp(x.to(dt), self.fc1.weight.to(dt),
                                 self.fc1.bias, self.fc2.weight.to(dt),
                                 self.fc2.bias)
        h = self._act(self.fc1(x))
        with unkept_products():
            return self.fc2(h)


class Attention(nn.Module):
    """Multi-head self-attention that optionally emits distillation
    importance: ``'cls'`` = head-mean CLS-query softmax row over the patch
    keys, (B, N-1); ``'mean'`` = head-and-query mean, (B, N)."""

    def __init__(self, dim: int, num_heads: int,
                 importance_mode: Optional[str] = None,
                 dtype: torch.dtype = torch.float32,
                 attention_impl: str = "auto"):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.importance_mode = importance_mode
        self.qkv = Linear(dim, 3 * dim, dtype)
        self.proj = Linear(dim, dim, dtype)
        self.compute_dtype = dtype
        self.attention_impl = attention_impl

    @property
    def local_heads(self) -> int:
        """The heads this module holds (all of them without a model
        group)."""
        return self.qkv.out_features // (3 * self.head_dim)

    def share(self, x32, tp, impl: Optional[str] = None):
        """A tensor-parallel rank's share: ``(the f32 sums of proj over its
        heads, no bias; its heads' importance rows over the block's head
        count, or None)`` from ``x32`` (the normalised input in f32, after
        ``copy_in``); zeros for a rank without heads."""
        b, n, d = x32.shape
        h, e = self.local_heads, self.head_dim
        mode = self.importance_mode
        n_imp = n if mode == "mean" else n - 1
        if not h:
            imp = (x32.new_zeros((b, n_imp), dtype=torch.float32)
                   if mode else None)
            return tp.zero_share(x32, (b, n, d)), imp
        out, imp = self._heads_out(self.qkv(x32), h, e, impl)
        if imp is not None:  # the head sum over the block's head count
            imp = imp * (h / self.num_heads)
        return torch.matmul(out.float(), self.proj.weight.float().t()), imp

    def _heads_out(self, qkv, h: int, e: int, impl):
        """The attention output (B, N, h E) of the slab's ``h`` heads and
        the head-mean importance (or None)."""
        b, n, _ = qkv.shape
        scale = e ** -0.5
        impl = impl or self.attention_impl
        if impl == "auto":
            impl = attention_auto_impl(qkv.is_cuda)
        if impl == "flash" and self.importance_mode != "mean":
            if self.importance_mode == "cls":
                out, imp_full = flash_attention_qkv_with_importance(
                    qkv, h, float(scale))
                return out, imp_full[:, 1:]  # strip the CLS key
            return flash_attention_qkv(qkv, h, float(scale)), None
        q, k, v = (t.reshape(b, n, h, e).transpose(1, 2)
                   for t in qkv.split(h * e, dim=-1))  # (B, H, N, E)
        scores = torch.matmul(q, k.transpose(-1, -2))
        importance = None
        if self.importance_mode == "mean":
            probs = torch.softmax(scores.float() * scale, dim=-1)
            importance = probs.mean(dim=(1, 2))
            out = torch.matmul(probs.to(self.compute_dtype), v)
        else:
            if self.importance_mode == "cls":
                cls_probs = torch.softmax(scores[:, :, 0].float() * scale, -1)
                importance = cls_probs[..., 1:].mean(1)
            probs = torch.softmax((scores * scale).float(), dim=-1)
            out = torch.matmul(probs.to(self.compute_dtype), v)
        return out.transpose(1, 2).reshape(b, n, h * e), importance

    def forward(self, x, impl: Optional[str] = None):
        """``impl``: overrides ``attention_impl`` for this call."""
        out, importance = self._heads_out(self.qkv(x), self.num_heads,
                                          x.shape[-1] // self.num_heads, impl)
        return self.proj(out), importance


class PatchEmbed(nn.Module):
    """Patchify + projection as a stride-p convolution on NHWC input.

    The conv weight (D, C, p, p) flattens in (c, dy, dx) order, so it is the
    JAX package's (C*p*p, D) Dense-shaped kernel transposed."""

    def __init__(self, patch_size: int, embed_dim: int, in_chans: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size,
                              stride=patch_size)
        self.compute_dtype = dtype

    def forward(self, x):  # (B, S, S, C) -> (B, N, D)
        dt = self.compute_dtype
        y = F.conv2d(x.permute(0, 3, 1, 2).to(dt), self.proj.weight.to(dt),
                     self.proj.bias.to(dt), stride=self.proj.stride)
        return y.flatten(2).transpose(1, 2)


class Block(nn.Module):
    """Pre-LN transformer block returning (x, importance)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float,
                 importance_mode: Optional[str] = None,
                 layerscale_init: Optional[float] = None,
                 has_cls_token: bool = True,
                 dtype: torch.dtype = torch.float32, norm_eps: float = 1e-6,
                 attention_impl: str = "auto", mlp_impl: str = "auto",
                 mlp: str = "gelu", mlp_hidden: Optional[int] = None):
        super().__init__()
        self.num_heads = num_heads
        self.importance_mode = importance_mode
        self.has_cls_token = has_cls_token
        self.compute_dtype = dtype
        self.norm_eps = norm_eps
        self.attention_impl = attention_impl
        self.mlp_impl = mlp_impl
        self.norm1 = LayerNorm(dim, norm_eps, dtype)
        self.attn = Attention(dim, num_heads, importance_mode, dtype)
        self.ls1 = (LayerScale(dim, layerscale_init)
                    if layerscale_init is not None else None)
        self.norm2 = LayerNorm(dim, norm_eps, dtype)
        self.mlp = Mlp(dim, mlp_hidden or int(dim * mlp_ratio), dtype,
                       kind=mlp)
        self.ls2 = (LayerScale(dim, layerscale_init)
                    if layerscale_init is not None else None)
        self.tp = None  # the model group (set_tp)

    def set_tp(self, tp, shard: dict) -> None:
        """Make this block a rank's of the model group ``tp``: its qkv,
        proj, fc1 and fc2 parameters become the tensors of ``shard`` (keys
        relative to the block, e.g. ``'attn.qkv.weight'``, cut by
        ``port.shard_state_dict``), their ``requires_grad`` kept. A SwiGLU
        block is not sharded: its packed [a | g] ``mlp.fc1`` would need
        each rank's units of both halves."""
        if tp is not None and self.mlp.kind == "swiglu":
            raise ValueError(
                "tensor parallelism does not shard a SwiGLU block: its "
                "mlp.fc1 packs [a | g], (2 F, D)")
        for name, t in shard.items():
            mod_name, _, leaf = name.rpartition(".")
            mod = self.get_submodule(mod_name)
            old = getattr(mod, leaf)
            setattr(mod, leaf, nn.Parameter(t.to(old.device, old.dtype),
                                            requires_grad=old.requires_grad))
            if leaf == "weight":
                mod.out_features, mod.in_features = t.shape
        self.tp = tp

    def _attn_path(self, x, drop) -> str:
        """``layers.py:392-429``: 'fused_block' (K1), 'fused_block_train'
        (K3) or the module chain."""
        impl = self.attention_impl
        bf16_3d = self.compute_dtype == torch.bfloat16 and x.dim() == 3
        fusable = self.importance_mode == "cls" and bf16_3d and drop is None
        if impl == "auto" and fusable and x.is_cuda:
            impl = "fused_block"
        if impl == "fused_block" and not fusable:
            impl = "auto"
        fusable_train = self.importance_mode is None and bf16_3d
        if impl == "auto" and fusable_train and x.is_cuda:
            impl = "fused_block_train"
        if impl == "fused_block_train" and not fusable_train:
            impl = "auto"
        return impl

    def kernel_halves(self, x, drop) -> bool:
        """Whether both halves take the training kernels (K3 and K4)."""
        return (self._attn_path(x, drop) == "fused_block_train"
                and self._mlp_path(x) == "fused_ln")

    def _mlp_path(self, x) -> str:
        """'fused_ln' (K2 / K4, K2g for SwiGLU) or the module chain
        (``block_mlp_path``). K2g has no backward: a SwiGLU MLP under
        autograd takes the module chain."""
        path = block_mlp_path(self.mlp_impl, x.is_cuda, self.compute_dtype,
                              x.dim(), self.mlp.kind)
        if (path == "fused_ln" and self.mlp.kind == "swiglu"
                and torch.is_grad_enabled()):
            return "auto"
        return path

    @staticmethod
    def _mlp_span(buf):
        """The tracer's ``teacher_mlp`` span around the MLP half of a block
        that writes the collection stack (the frozen teacher's)."""
        return (trace.span("teacher_mlp") if buf is not None
                else contextlib.nullcontext())

    def _fold(self, w, b, ls):
        """LayerScale folded into the (out, in) weight and bias, outside
        the kernel (``layers.py:438-445``, ``528-532``). On a rank of a
        model group the weight is its shard: gamma enters it through
        ``copy_in``, so that gamma's gradient sums the ranks' shares."""
        if ls is None:
            return w, b
        g = ls.gamma.float()
        gw = g if self.tp is None else self.tp.copy_in(g)
        return w * gw[:, None], b * g

    @staticmethod
    def _mask(drop, branch: int, b: int, device) -> torch.Tensor:
        """The (B,) f32 stochastic-depth multiplier the kernels take:
        ``where(keep_mask, 1/keep, 0)``, keep in f32 (``layers.py:130-137``);
        ones when deterministic."""
        if drop is None:
            return torch.ones(b, device=device)
        keep = torch.tensor(drop[0], dtype=torch.float32, device=device)
        return torch.where(drop[1][branch], 1.0 / keep,
                           torch.zeros((), device=device))

    def forward(self, x, drop=None, buf: Optional[torch.Tensor] = None,
                idx: int = 0):
        """``drop``: None (deterministic) or ``(keep, masks)`` with masks a
        (2, B) bool draw for the two residual branches. ``buf``: the flat
        (L*B*N, D) collection stack that receives this block's output at
        rows ``[idx*B*N, (idx+1)*B*N)``."""
        if self.tp is not None:
            return self._forward_tp(x, drop, buf, idx)
        bf = torch.bfloat16
        attn_path = self._attn_path(x, drop)
        importance = None
        if attn_path in ("fused_block", "fused_block_train"):
            wp, bp = self._fold(self.attn.proj.weight, self.attn.proj.bias,
                                self.ls1)
            args = (self.norm1.weight.float(), self.norm1.bias.float(),
                    self.attn.qkv.weight.to(bf), self.attn.qkv.bias.float(),
                    wp.to(bf), bp.float(), self.num_heads, self.norm_eps)
            if attn_path == "fused_block":
                x, imp_full = fused_block_attn(x.contiguous(), *args)
                importance = imp_full[:, 1:]  # strip the CLS key
            else:
                with unkept_products():
                    x = fused_block_attn_train(
                        x, self._mask(drop, 0, x.shape[0], x.device), *args)
        else:
            # the module chain: an explicit 'module' means no kernel in the
            # attention or the MLP (the LayerNorms keep theirs); 'auto' is
            # left to the module (layers.py:481-483, 553-555)
            y, importance = self.attn(
                self.norm1(x), {"module": "einsum"}.get(attn_path, attn_path))
            if self.ls1 is not None:
                y = self.ls1(y)
            if drop is not None:
                y = drop_path(y, drop[1][0], drop[0])
            x = x + y

        with self._mlp_span(buf):
            x = self._mlp_half(x, drop, buf, idx)

        if importance is None:
            n_tok = x.shape[1] - 1 if self.has_cls_token else x.shape[1]
            importance = torch.zeros((x.shape[0], n_tok), device=x.device)
        return x, importance

    def _mlp_half(self, x, drop, buf, idx):
        mlp_path = self._mlp_path(x)
        if mlp_path == "fused_ln":
            # the weights in the block's dtype, as the reference casts them
            # to self.dtype (layers.py:534-540)
            dt = self.compute_dtype
            w2, b2 = self._fold(self.mlp.fc2.weight, self.mlp.fc2.bias,
                                self.ls2)
            args = (self._mask(drop, 1, x.shape[0], x.device),
                    self.norm2.weight.float(), self.norm2.bias.float(),
                    self.mlp.fc1.weight.to(dt), self.mlp.fc1.bias.float(),
                    w2.to(dt), b2.float())
            if self.mlp.kind == "swiglu":
                return fused_ln_swiglu_collect(x.contiguous(), *args, buf, idx,
                                               self.norm_eps)
            if buf is not None:
                return fused_ln_mlp_collect(x.contiguous(), *args, buf, idx,
                                            self.norm_eps)
            with unkept_products():
                return fused_ln_mlp(x, *args, self.norm_eps)
        y = self.mlp(self.norm2(x),
                     {"module": "dense"}.get(mlp_path, mlp_path))
        if self.ls2 is not None:
            y = self.ls2(y)
        if drop is not None:
            y = drop_path(y, drop[1][1], drop[0])
        x = x + y
        if buf is not None:
            m = x.shape[0] * x.shape[1]
            if buf.dtype != x.dtype or buf.shape[-1] != x.shape[-1]:
                raise ValueError(
                    f"flat collect stack {tuple(buf.shape)}/{buf.dtype} "
                    f"does not match block output {tuple(x.shape)}/{x.dtype}"
                )
            buf[idx * m:(idx + 1) * m] = x.reshape(m, x.shape[-1])
        return x

    # ------------------------------------------------- tensor parallelism

    def _finish(self, x, acc, bias, ls, drop, branch: int):
        """The module chain's end of a half on a model group's rank, after
        the shares' sum ``acc`` (f32): bias, rounded to the block's dtype
        once, LayerScale, stochastic depth, residual."""
        y = (acc + bias.float()).to(self.compute_dtype)
        if ls is not None:
            y = ls(y)
        if drop is not None:
            y = drop_path(y, drop[1][branch], drop[0])
        return x + y

    def _forward_tp(self, x, drop, buf, idx):
        tp = self.tp
        bf, dt = torch.bfloat16, self.compute_dtype
        attn_path = self._attn_path(x, drop)
        importance = None
        if attn_path in ("fused_block", "fused_block_train"):
            wp, bp = self._fold(self.attn.proj.weight, self.attn.proj.bias,
                                self.ls1)
            args = (self.norm1.weight.float(), self.norm1.bias.float(),
                    self.attn.qkv.weight.to(bf), self.attn.qkv.bias.float(),
                    wp.to(bf), bp.float(), self.attn.local_heads,
                    self.attn.head_dim)
            if attn_path == "fused_block":
                x, imp_full = fused_block_attn_tp(
                    x.contiguous(), *args, self.num_heads, self.norm_eps,
                    tp.all_reduce_)
                importance = imp_full[:, 1:]  # strip the CLS key
            else:
                with unkept_products():
                    x = fused_block_attn_train_tp(
                        x, self._mask(drop, 0, x.shape[0], x.device), *args,
                        self.norm_eps, tp.all_reduce_)
        else:
            acc, importance = self.attn.share(
                tp.copy_in(self.norm1(x).float()), tp,
                {"module": "einsum"}.get(attn_path, attn_path))
            if importance is not None:
                importance = tp.reduce(importance)
            x = self._finish(x, tp.reduce(acc), self.attn.proj.bias, self.ls1,
                             drop, 0)

        with self._mlp_span(buf):
            mlp_path = self._mlp_path(x)
            if mlp_path == "fused_ln":
                w2, b2 = self._fold(self.mlp.fc2.weight, self.mlp.fc2.bias,
                                    self.ls2)
                args = (self._mask(drop, 1, x.shape[0], x.device),
                        self.norm2.weight.float(), self.norm2.bias.float(),
                        self.mlp.fc1.weight.to(dt), self.mlp.fc1.bias.float(),
                        w2.to(dt), b2.float())
                if buf is not None:
                    x = fused_ln_mlp_collect_tp(x.contiguous(), *args, buf,
                                                idx, self.norm_eps,
                                                tp.all_reduce_)
                else:
                    with unkept_products():
                        x = fused_ln_mlp_tp(x, *args, self.norm_eps,
                                            tp.all_reduce_)
            else:
                acc = self.mlp.share(
                    tp.copy_in(self.norm2(x).float()), tp,
                    {"module": "dense"}.get(mlp_path, mlp_path))
                x = self._finish(x, tp.reduce(acc), self.mlp.fc2.bias,
                                 self.ls2, drop, 1)
                if buf is not None:
                    m = x.shape[0] * x.shape[1]
                    buf[idx * m:(idx + 1) * m] = x.reshape(m, x.shape[-1])

        if importance is None:
            n_tok = x.shape[1] - 1 if self.has_cls_token else x.shape[1]
            importance = torch.zeros((x.shape[0], n_tok), device=x.device)
        return x, importance
