"""Model registry and teacher/student factories, ViT part (counterpart of
``basd_tpu/models/registry.py``).

Presets, metadata probing (the reference's ``probe_model`` surface),
initialisation (flax-style defaults, or the reference's fan-in scheme),
teacher loading (random init from a seed, or a timm-layout ``.pth`` loaded
with ``load_state_dict``: the port keeps timm's key names), teacher
extraction and the intrinsic-dimension student sizing.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional

import torch

from basd_tpu_torch.models.tokens import PackedTokens
from basd_tpu_torch.models.vit import ViTConfig, VisionTransformer

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)

_VIT_PRESETS: dict[str, dict] = {
    "deit_tiny_patch16_224": dict(embed_dim=192, depth=12, num_heads=3,
                                  mlp_ratio=4.0, patch_size=16),
    "deit_small_patch16_224": dict(embed_dim=384, depth=12, num_heads=6,
                                   mlp_ratio=4.0, patch_size=16),
    "deit_base_patch16_224": dict(embed_dim=768, depth=12, num_heads=12,
                                  mlp_ratio=4.0, patch_size=16),
    "vit_large_patch16_224": dict(embed_dim=1024, depth=24, num_heads=16,
                                  mlp_ratio=4.0, patch_size=16),
    "dinov2_vitb14": dict(embed_dim=768, depth=12, num_heads=12,
                          mlp_ratio=4.0, patch_size=14, layerscale_init=1e-5),
    "dinov2_vitl14": dict(embed_dim=1024, depth=24, num_heads=16,
                          mlp_ratio=4.0, patch_size=14, layerscale_init=1e-5),
    "dinov2_vits14": dict(embed_dim=384, depth=12, num_heads=6,
                          mlp_ratio=4.0, patch_size=14, layerscale_init=1e-5),
    "vit_small_patch16_224": dict(embed_dim=384, depth=12, num_heads=6,
                                  mlp_ratio=4.0, patch_size=16),
    "vit_base_patch16_224": dict(embed_dim=768, depth=12, num_heads=12,
                                 mlp_ratio=4.0, patch_size=16),
    "deit3_small_patch16_224": dict(embed_dim=384, depth=12, num_heads=6,
                                    mlp_ratio=4.0, patch_size=16,
                                    layerscale_init=1e-6),
    "deit3_base_patch16_224": dict(embed_dim=768, depth=12, num_heads=12,
                                   mlp_ratio=4.0, patch_size=16,
                                   layerscale_init=1e-6),
    "deit3_large_patch16_224": dict(embed_dim=1024, depth=24, num_heads=16,
                                    mlp_ratio=4.0, patch_size=16,
                                    layerscale_init=1e-6),
}


def available_models() -> list[str]:
    return sorted(_VIT_PRESETS)


@dataclass(frozen=True)
class ModelBundle:
    """A model + metadata (the reference's ``TeacherModel`` analogue)."""

    name: str
    module: Any
    cfg: ViTConfig
    info: dict
    mean: tuple[float, ...] = _IMAGENET_MEAN
    std: tuple[float, ...] = _IMAGENET_STD


def _vit_info(cfg: ViTConfig) -> dict:
    return {
        "embed_dim": cfg.embed_dim,
        "heads_per_layer": [cfg.num_heads] * cfg.depth,
        "depth": cfg.depth,
        "mlp_ratio": cfg.mlp_ratio,
        "layer_paths": [f"blocks.{i}" for i in range(cfg.depth)],
        "attn_subpath": "attn",
        "has_cls_token": cfg.use_cls_token,
        "feature_format": "token",
        "num_tokens": cfg.num_tokens,
    }


def create_model(
    name: str,
    *,
    img_size: int,
    num_classes: int = 0,
    drop_path_rate: float = 0.0,
    arch_overrides: dict | None = None,
    importance_mode: Optional[str] = None,
    remat: bool = False,
    remat_policy: Optional[str] = None,
    collect: bool = False,
    dtype: torch.dtype = torch.float32,
    attention_impl: str = "auto",
    mlp_impl: str = "auto",
) -> ModelBundle:
    """Build a ViT by preset name, or an unlisted one from explicit arch
    kwargs {embed_dim, depth, num_heads, [mlp_ratio, patch_size,
    layerscale_init]}. Parameters are uninitialised; see ``init_model``.
    ``attention_impl`` / ``mlp_impl`` select the blocks' kernel dispatch
    (``layers.Block``; the ``tpu.*_impl`` config keys); ``remat_policy``:
    ``tpu.remat_policy`` (``vit.VisionTransformer``)."""
    if name in _VIT_PRESETS:
        preset = dict(_VIT_PRESETS[name])
        cfg = ViTConfig(
            img_size=img_size,
            patch_size=preset.pop("patch_size"),
            num_classes=num_classes,
            drop_path_rate=drop_path_rate,
            layerscale_init=preset.pop("layerscale_init", None),
            name=name,
            **preset,
        ).with_overrides(arch_overrides)
    else:
        ov = dict(arch_overrides or {})
        required = ("embed_dim", "depth", "num_heads")
        if ov.pop("kind", "vit") != "vit" or not all(k in ov for k in required):
            raise KeyError(
                f"unknown model preset {name!r} (and arch_overrides lacks "
                f"{required} for a custom ViT); available: {available_models()}"
            )
        cfg = ViTConfig(
            img_size=img_size,
            patch_size=int(ov.pop("patch_size", 16)),
            num_classes=num_classes,
            drop_path_rate=drop_path_rate,
            layerscale_init=ov.pop("layerscale_init", None),
            name=name,
            mlp_ratio=float(ov.pop("mlp_ratio", 4.0)),
            **ov,
        )
    module = VisionTransformer(cfg, importance_mode=importance_mode,
                               remat=remat, remat_policy=remat_policy,
                               collect=collect, dtype=dtype,
                               attention_impl=attention_impl,
                               mlp_impl=mlp_impl)
    return ModelBundle(name, module, cfg, _vit_info(cfg))


def probe(bundle: ModelBundle) -> dict:
    """API-parity alias for the reference's ``probe_model``."""
    return dict(bundle.info)


def _trunc_normal(shape, std: float, g: torch.Generator) -> torch.Tensor:
    """Normal(0, std) truncated to +-2 std, by inverse CDF."""
    lo, hi = (1.0 + math.erf(-2.0 / math.sqrt(2.0))) / 2.0, (
        1.0 + math.erf(2.0 / math.sqrt(2.0))) / 2.0
    u = torch.rand(shape, generator=g) * (hi - lo) + lo
    return torch.erfinv(2.0 * u - 1.0) * (std * math.sqrt(2.0))


def init_model(bundle: ModelBundle, seed: int, *,
               fan_in_init: bool = False) -> None:
    """Initialise parameters in place from ``seed``.

    Default: the flax initialisers of the JAX package (lecun-normal Dense
    kernels, zero biases, unit LayerNorm, cls ~ N(0, 1e-6), pos ~
    trunc-N(0, 0.02)). ``fan_in_init``: the reference's re-init
    (``src/train.py:19-32``, ``registry.apply_fan_in_init``): Dense weights
    ~ N(0, 2/fan_in), the patch conv ~ N(0, 2/(p*p*D)), biases 0, LN scale 1;
    cls/pos keep their default init. Draws come from a CPU generator (the
    distributions match the reference's, not its random bits).
    """
    g = torch.Generator().manual_seed(int(seed))
    module = bundle.module
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if name == "cls_token":
                new = torch.randn(p.shape, generator=g) * 1e-6
            elif name == "pos_embed":
                new = _trunc_normal(p.shape, 0.02, g)
            elif leaf == "gamma":
                new = p.detach().cpu()  # LayerScale keeps its init value
            elif leaf == "bias":
                new = torch.zeros(p.shape)
            elif name.endswith("norm1.weight") or name.endswith(
                    "norm2.weight") or name == "norm.weight":
                new = torch.ones(p.shape)
            else:  # Dense / conv weight, torch (out, in, ...) layout
                fan_in = p[0].numel()
                if fan_in_init:
                    if name.startswith("patch_embed"):
                        std = math.sqrt(2.0 / (p.shape[2] * p.shape[3]
                                               * p.shape[0]))
                    else:
                        std = math.sqrt(2.0 / fan_in)
                    new = torch.randn(p.shape, generator=g) * std
                else:
                    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                    new = _trunc_normal(p.shape, std, g)
            p.copy_(new.to(p.dtype))


def load_teacher(
    model_name: str,
    img_size: int,
    *,
    device: torch.device,
    seed: int = 0,
    checkpoint_path: str | None = None,
    dtype: torch.dtype = torch.bfloat16,
    arch_overrides: dict | None = None,
    attention_impl: str = "auto",
) -> ModelBundle:
    """The frozen teacher (reference ``load_teacher``): importance 'cls',
    per-layer tokens collected into the flat stack, eval mode, no grads.
    ``checkpoint_path``: a timm-layout state-dict ``.pth``; otherwise the
    teacher is randomly initialised from ``seed``. ``attention_impl``:
    ``tpu.teacher_attention_impl``."""
    bundle = create_model(
        model_name, img_size=img_size, num_classes=0,
        arch_overrides=arch_overrides, importance_mode="cls", collect=True,
        dtype=dtype, attention_impl=attention_impl,
    )
    init_model(bundle, seed)
    if checkpoint_path:
        sd = torch.load(checkpoint_path, map_location="cpu", weights_only=True)
        sd = sd.get("model_state_dict", sd)  # basd-export's .pth wraps it
        sd = {k: v for k, v in sd.items() if not k.startswith("head.")}
        bundle.module.load_state_dict(sd, strict=True)
    bundle.module.to(device).eval().requires_grad_(False)
    info = bundle.info
    print(
        f"teacher_loaded model={model_name} embed_dim={info['embed_dim']} "
        f"depth={info['depth']} heads_per_layer={info['heads_per_layer']} "
        f"mlp_ratio={info['mlp_ratio']:.1f} "
        f"feature_format={info['feature_format']} "
        f"has_cls={info['has_cls_token']} attn_subpath={info['attn_subpath']} "
        f"mean={bundle.mean} std={bundle.std}"
    )
    return bundle


@torch.no_grad()
def teacher_extract(bundle: ModelBundle, x: torch.Tensor,
                    collection_init: Optional[torch.Tensor] = None):
    """Per-layer tokens + reduced attention importance (L, B, N_patch) of
    the frozen teacher (reference ``extract_intermediates``). Tokens are
    ``PackedTokens`` for a collecting teacher, else a dense stack.
    ``collection_init``: a reused (L*B*N, D) buffer (fully overwritten)."""
    out = bundle.module(x, deterministic=True, collection_init=collection_init)
    return out["tokens"], out["importance"]


def derive_student_arch(teacher_info: dict, intrinsic_dim: int) -> dict:
    """Student auto-sizing from teacher intrinsic dimensionality
    (reference ``_derive_from_teacher``, ``src/train.py:57-66``)."""
    head_dim = teacher_info["embed_dim"] // teacher_info["heads_per_layer"][0]
    d_s = -(-intrinsic_dim // head_dim) * head_dim  # ceil to head_dim
    d_s = min(d_s, teacher_info["embed_dim"])
    return {
        "embed_dim": d_s,
        "depth": teacher_info["depth"],
        "num_heads": d_s // head_dim,
        "mlp_ratio": teacher_info["mlp_ratio"],
    }


def estimate_intrinsic_dim(bundle: ModelBundle, images: torch.Tensor) -> int:
    """MP rank of last-layer teacher tokens over calibration images
    (reference ``estimate_intrinsic_dim``)."""
    from basd_tpu_torch.ops.mp_rank import marchenko_pastur_rank

    tokens, _ = teacher_extract(bundle, images)
    if isinstance(tokens, PackedTokens):
        tokens = tokens.to_dense()
    flat = tokens[-1].reshape(-1, tokens.shape[-1]).float()
    return int(marchenko_pastur_rank(flat))
