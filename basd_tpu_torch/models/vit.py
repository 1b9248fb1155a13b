"""Vision Transformer with per-layer token + importance collection
(counterpart of ``basd_tpu/models/vit.py``).

A Python loop over the blocks replaces ``nn.scan``; ``torch.utils.checkpoint``
replaces ``jax.checkpoint`` for ``remat`` (the reference's
``set_grad_checkpointing(True)``). ``remat_policy`` None or ``'full'``
recomputes the whole block, so a remat'd block's kernels run twice per
training step, as under the JAX package's ``nn.remat``. ``'dots'``
(``vit.py:126-136``: ``dots_saveable`` plus the attention output
``attn_out``) is selective checkpointing with ``dots_policy``: the outputs
of the block's products (``mm``, ``addmm``, ``bmm``) and of K10a's forward
(the ``basd_tpu_torch::flash_attention_fwd`` operator: o and its
logsumexp) are kept, everything else is recomputed. Per block that keeps,
besides the block input: on the flash path (K10 / K11) the qkv and proj
products, o and lse, recomputing the LayerNorms and K11, so K10a runs once
per forward where ``full`` runs it twice (the JAX package keeps o but not
lse and re-runs its flash forward for lse); on the einsum / dense chain the
qkv, scores, P.V, proj and fc1 products; on the fused path (K3 / K4),
whose kernels' products are their own (``layers.unkept_products``), nothing
more: there ``dots`` is ``full`` (``remat_block``). With
``collect``, the frozen teacher writes each layer's output into one flat
(L*B*N, D) stack, which the caller may preallocate and reuse across steps
(``collection_init``), and returns it as ``PackedTokens``.
``attention_impl``/``mlp_impl`` select every block's kernel dispatch
(``layers.Block``); the final norm is ``layers.LayerNorm`` (K5 on CUDA).
``shard_vit`` makes a built model one rank's of a model group
(``parallel.mesh.ModelParallel``): its blocks keep their shards of qkv,
proj, fc1 and fc2 and sum their halves over the group (``layers.Block``);
the embeddings, norms and head stay whole. Which collectives run in which
pass: each block half's forward sums its shares once (the fused halves in
place, the module chain through ``reduce``); under remat the recompute in
the backward sums them again; the backward sums each half's input
gradient once (the fused halves with their LN gradients, in place; the
module chain through ``copy_in``).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from basd_tpu_torch.kernels import flash_attention  # noqa: F401 (its operator)
from basd_tpu_torch.models.layers import (
    Block,
    LayerNorm,
    Linear,
    PatchEmbed,
    products_unkept,
)
from basd_tpu_torch.models.port import (
    gather_state_dict,
    shard_state_dict,
    tp_key,
)
from basd_tpu_torch.models.tokens import PackedTokens
from basd_tpu_torch.parallel.mesh import check_shards

_aten = torch.ops.aten
# the operators whose outputs ``remat_policy='dots'`` keeps
DOTS_KEPT = (_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
             torch.ops.basd_tpu_torch.flash_attention_fwd.default)


def dots_policy(ctx, op, *args, **kwargs):
    """Keep the outputs of the products and of K10a's forward, except those
    made under ``layers.unkept_products``; recompute everything else."""
    if op in DOTS_KEPT and not products_unkept():
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_contexts():
    return create_selective_checkpoint_contexts(dots_policy)


def remat_block(blk: Block, x: torch.Tensor, drop, policy: Optional[str]):
    """One block under ``torch.utils.checkpoint`` with ``policy`` (None /
    'full': recompute all; 'dots': ``dots_policy``). A block whose halves
    are both kernels (K3, K4) has no product to keep, so 'dots' takes
    'full' there, without the policy's dispatch modes."""
    if policy == "dots" and not blk.kernel_halves(x, drop):
        return checkpoint(blk, x, drop, use_reentrant=False,
                          context_fn=_dots_contexts)
    return checkpoint(blk, x, drop, use_reentrant=False)


@dataclass(frozen=True)
class ViTConfig:
    img_size: int = 224
    patch_size: int = 16
    embed_dim: int = 192
    depth: int = 12
    num_heads: int = 3
    mlp_ratio: float = 4.0
    num_classes: int = 1000
    drop_path_rate: float = 0.0
    use_cls_token: bool = True
    layerscale_init: Optional[float] = None
    norm_eps: float = 1e-6
    name: str = "vit"
    # the blocks' MLP: 'gelu', or 'swiglu' (fc1 packed [a | g]) with its
    # hidden width stated in ``mlp_hidden``
    mlp: str = "gelu"
    mlp_hidden: Optional[int] = None

    def __post_init__(self):
        if self.mlp not in ("gelu", "swiglu"):
            raise ValueError(f"unknown MLP kind {self.mlp!r}; known: gelu, "
                             "swiglu")
        if self.mlp == "swiglu" and not self.mlp_hidden:
            raise ValueError("a SwiGLU MLP states its hidden width "
                             "(mlp_hidden)")

    @property
    def hidden_dim(self) -> int:
        """The MLP's hidden width F: ``mlp_hidden``, else D x ``mlp_ratio``
        (fc1 makes 2 F outputs for SwiGLU)."""
        return self.mlp_hidden or int(self.embed_dim * self.mlp_ratio)

    @property
    def num_patches(self) -> int:
        return (self.img_size // self.patch_size) ** 2

    @property
    def num_tokens(self) -> int:
        """Patch tokens, CLS excluded (the reference's ``num_tokens``)."""
        return self.num_patches

    def with_overrides(self, overrides: dict | None) -> "ViTConfig":
        if not overrides:
            return self
        allowed = {"embed_dim", "depth", "num_heads", "mlp_ratio", "mlp",
                   "mlp_hidden"}
        unknown = set(overrides) - allowed
        if unknown:
            raise ValueError(f"unsupported arch overrides: {sorted(unknown)}")
        return replace(self, **{k: overrides[k] for k in overrides})


def drop_path_rates(cfg: ViTConfig) -> np.ndarray:
    """Linearly spaced per-layer stochastic-depth rates (timm), f32."""
    return np.linspace(0.0, cfg.drop_path_rate, cfg.depth).astype(np.float32)


class VisionTransformer(nn.Module):
    """Returns ``{'logits', 'tokens', 'importance' (L, B, N_patch)}``;
    ``tokens`` is (L, B, N_patch, D), or ``PackedTokens`` with ``collect``.
    Input images are NHWC (B, S, S, 3), the JAX package's layout."""

    def __init__(self, cfg: ViTConfig, importance_mode: Optional[str] = None,
                 remat: bool = False, collect: bool = False,
                 dtype: torch.dtype = torch.float32,
                 attention_impl: str = "auto", mlp_impl: str = "auto",
                 remat_policy: Optional[str] = None):
        super().__init__()
        if remat and remat_policy not in (None, "full", "dots"):
            raise ValueError(f"unknown remat_policy {remat_policy!r}")
        self.cfg = cfg
        self.remat = remat
        self.remat_policy = remat_policy
        # forward-only collection (the frozen teacher); a remat'd model
        # collects per-layer outputs instead (vit.py:137)
        self.collect = collect and not remat
        self.compute_dtype = dtype
        d = cfg.embed_dim
        self.patch_embed = PatchEmbed(cfg.patch_size, d, dtype=dtype)
        n = cfg.num_patches + (1 if cfg.use_cls_token else 0)
        self.cls_token = (nn.Parameter(torch.zeros(1, 1, d))
                          if cfg.use_cls_token else None)
        self.pos_embed = nn.Parameter(torch.zeros(1, n, d))
        self.blocks = nn.ModuleList(
            Block(d, cfg.num_heads, cfg.mlp_ratio,
                  importance_mode=importance_mode,
                  layerscale_init=cfg.layerscale_init,
                  has_cls_token=cfg.use_cls_token, dtype=dtype,
                  norm_eps=cfg.norm_eps, attention_impl=attention_impl,
                  mlp_impl=mlp_impl, mlp=cfg.mlp, mlp_hidden=cfg.hidden_dim)
            for _ in range(cfg.depth)
        )
        self.norm = LayerNorm(d, cfg.norm_eps, dtype)
        self.head = (Linear(d, cfg.num_classes, dtype)
                     if cfg.num_classes > 0 else None)
        self.tp = None  # the model group (shard_vit)

    def forward(self, x, *, deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                drop_masks: Optional[torch.Tensor] = None,
                collection_init: Optional[torch.Tensor] = None):
        """``drop_masks``: optional (depth, 2, B) bool stochastic-depth
        draws (keep = True); drawn from ``generator`` when omitted."""
        cfg = self.cfg
        dt = self.compute_dtype
        b = x.shape[0]
        x = self.patch_embed(x)
        if self.cls_token is not None:
            x = torch.cat([self.cls_token.to(dt).expand(b, 1, -1), x], dim=1)
        x = x + self.pos_embed.to(dt)
        _, n, d = x.shape

        stochastic = not deterministic and cfg.drop_path_rate > 0.0
        rates = drop_path_rates(cfg)
        if stochastic and drop_masks is None:
            keeps = torch.as_tensor(1.0 - rates, device=x.device)
            u = torch.rand((cfg.depth, 2, b), generator=generator,
                           device=x.device)
            drop_masks = u < keeps[:, None, None]

        stack = None
        if self.collect:
            m = cfg.depth * b * n
            if collection_init is not None:
                # reused buffer: every slab is overwritten before any read
                if (tuple(collection_init.shape) != (m, d)
                        or collection_init.dtype != dt):
                    raise ValueError(
                        f"collection_init {tuple(collection_init.shape)}/"
                        f"{collection_init.dtype} != ({m}, {d})/{dt}"
                    )
                stack = collection_init
            else:
                stack = torch.empty((m, d), dtype=dt, device=x.device)

        tokens, importance, cls_rows = [], [], []
        for i, blk in enumerate(self.blocks):
            drop = None
            if stochastic:
                drop = (float(np.float32(1.0) - rates[i]), drop_masks[i])
            if self.remat and torch.is_grad_enabled():
                x, imp = remat_block(blk, x, drop, self.remat_policy)
            else:
                x, imp = blk(x, drop, buf=stack, idx=i)
            importance.append(imp)
            if self.collect:
                if cfg.use_cls_token:
                    cls_rows.append(x[:, 0, :])
            else:
                tokens.append(x[:, 1:, :] if cfg.use_cls_token else x)

        if self.collect:
            tok_out = PackedTokens(
                flat=stack.view(cfg.depth, b * n, d),
                cls=torch.stack(cls_rows) if cfg.use_cls_token else None,
                batch=b, num_tokens=n, has_cls=cfg.use_cls_token,
            )
        else:
            tok_out = torch.stack(tokens)

        x = self.norm(x)
        pooled = x[:, 0] if cfg.use_cls_token else x.mean(1)
        logits = self.head(pooled) if self.head is not None else pooled
        return {"logits": logits, "tokens": tok_out,
                "importance": torch.stack(importance)}


def shard_vit(module: "VisionTransformer", tp) -> "VisionTransformer":
    """Cut ``module``'s blocks, in place, down to rank ``tp.rank``'s shards
    of the full weights it holds (``port.shard_state_dict``): its heads of
    every attention, its hidden units of every MLP; refuses a split whose
    shards break TMA's 16-byte rows (``mesh.check_shards``). Returns it."""
    cfg = module.cfg
    check_shards(tp.world, cfg.embed_dim, cfg.num_heads,
                 module.blocks[0].mlp.fc1.out_features)
    for blk in module.blocks:
        full = {k: v.detach() for k, v in blk.named_parameters()}
        shard = shard_state_dict({"blocks.0." + k: v for k, v in full.items()},
                                 tp, cfg.num_heads)
        blk.set_tp(tp, {k[len("blocks.0."):]: v for k, v in shard.items()
                        if v is not full[k[len("blocks.0."):]]})
    module.tp = tp
    return module


def whole_vit(module: "VisionTransformer", tp) -> "VisionTransformer":
    """A copy of the sharded ``module`` on the CPU with whole blocks, the
    ranks' shards gathered over the model group ``tp`` (every rank of it
    must call; ``port.gather_state_dict``)."""
    cfg = module.cfg
    params = {k: p.detach() for k, p in module.named_parameters()}
    full = gather_state_dict(params, tp, cfg.num_heads, cfg.embed_dim,
                             cfg.hidden_dim)
    out = copy.deepcopy(module, memo={id(tp): None}).cpu()
    for i, blk in enumerate(out.blocks):
        prefix = f"blocks.{i}."
        blk.set_tp(None, {k[len(prefix):]: v.cpu() for k, v in full.items()
                          if k.startswith(prefix) and tp_key(k)})
    out.tp = None
    return out
