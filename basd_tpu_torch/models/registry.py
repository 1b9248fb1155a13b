"""Model registry and teacher/student factories (counterpart of
``basd_tpu/models/registry.py``).

Presets (ViTs, and the ConvNeXtV2 / ResNet teachers of the CNN-to-ViT
path), metadata probing (the reference's ``probe_model`` surface),
initialisation (flax-style defaults, or the reference's fan-in scheme),
teacher loading (random init from a seed, or a torch ``.pth`` ported by
``models.port.port_torch_checkpoint``: the port keeps timm's and
torchvision's key names; an unlisted name that comes with a checkpoint
gets its architecture from the state dict's shapes), teacher extraction
and the intrinsic-dimension student sizing.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional

import torch

from basd_tpu_torch.models import port
from basd_tpu_torch.models.convnext import ConvNeXtConfig, ConvNeXtV2
from basd_tpu_torch.models.resnet import ResNet, ResNetConfig
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
    # DINOv2's giant: SwiGLU with F = 4096 (its hub's (int(D x 4 x 2/3) + 7)
    # // 8 x 8; timm's vit_giant_patch14_dinov2)
    "dinov2_vitg14": dict(embed_dim=1536, depth=40, num_heads=24,
                          mlp_ratio=4.0, patch_size=14, layerscale_init=1e-5,
                          mlp="swiglu", mlp_hidden=4096),
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


_CNN_PRESETS: dict[str, dict] = {
    "convnextv2_tiny.fcmae": dict(kind="convnext", depths=(3, 3, 9, 3),
                                  dims=(96, 192, 384, 768)),
    "convnextv2_tiny": dict(kind="convnext", depths=(3, 3, 9, 3),
                            dims=(96, 192, 384, 768)),
    "resnet50": dict(kind="resnet", stage_sizes=(3, 4, 6, 3), width=64),
}


def available_models() -> list[str]:
    return sorted([*_VIT_PRESETS, *_CNN_PRESETS])


@dataclass(frozen=True)
class ModelBundle:
    """A model + metadata (the reference's ``TeacherModel`` analogue)."""

    name: str
    module: Any
    cfg: Any  # ViTConfig, ConvNeXtConfig or ResNetConfig
    info: dict
    mean: tuple[float, ...] = _IMAGENET_MEAN
    std: tuple[float, ...] = _IMAGENET_STD


def _vit_info(cfg: ViTConfig) -> dict:
    return {
        "embed_dim": cfg.embed_dim,
        "heads_per_layer": [cfg.num_heads] * cfg.depth,
        "depth": cfg.depth,
        "mlp_ratio": cfg.mlp_ratio,
        "mlp": cfg.mlp,
        "mlp_hidden": cfg.hidden_dim,
        "layer_paths": [f"blocks.{i}" for i in range(cfg.depth)],
        "attn_subpath": "attn",
        "has_cls_token": cfg.use_cls_token,
        "feature_format": "token",
        "num_tokens": cfg.num_tokens,
    }


def _cnn_info(cfg, img_size: int) -> dict:
    """A CNN teacher's metadata (reference ``_cnn_info``): one synthetic
    head and one "layer", the last stage's (H*W, C) map."""
    if isinstance(cfg, ConvNeXtConfig):
        depth = len(cfg.depths)
        layer_paths = [f"stages.{i}" for i in range(depth)]
        mlp_ratio = 4.0
    else:
        depth = len(cfg.stage_sizes)
        layer_paths = [f"layer{i + 1}" for i in range(depth)]
        mlp_ratio = 0.0
    # stem /4, then /2 per later stage
    reduction = 4 * 2 ** (depth - 1)
    return {
        "embed_dim": cfg.embed_dim,
        "heads_per_layer": [1],
        "depth": depth,
        "mlp_ratio": mlp_ratio,
        "layer_paths": layer_paths,
        "attn_subpath": None,
        "has_cls_token": False,
        "feature_format": "nhwc",
        "num_tokens": (img_size // reduction) ** 2,
    }


def _cnn_bundle(name: str, kind: str, arch: dict, img_size: int,
                dtype: torch.dtype) -> ModelBundle:
    if kind == "convnext":
        if not all(k in arch for k in ("depths", "dims")):
            raise KeyError(f"custom convnext {name!r} needs arch kwargs "
                           "('depths', 'dims')")
        cfg = ConvNeXtConfig(depths=tuple(arch["depths"]),
                             dims=tuple(arch["dims"]), name=name)
        module = ConvNeXtV2(cfg, dtype=dtype)
    else:
        if "stage_sizes" not in arch:
            raise KeyError(f"custom resnet {name!r} needs arch kwarg "
                           "'stage_sizes'")
        cfg = ResNetConfig(stage_sizes=tuple(arch["stage_sizes"]),
                           width=int(arch.get("width", 64)), name=name)
        module = ResNet(cfg, dtype=dtype)
    return ModelBundle(name, module, cfg, _cnn_info(cfg, img_size))


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
    """Build a model by preset name, or an unlisted one from explicit arch
    kwargs: a ViT {embed_dim, depth, num_heads, [mlp_ratio, patch_size,
    layerscale_init, use_cls_token, mlp, mlp_hidden]} (``mlp`` 'gelu' or
    'swiglu'), or with ``kind='convnext'`` {depths,
    dims} / ``kind='resnet'`` {stage_sizes, [width]} a CNN. Parameters are
    uninitialised; see ``init_model``. ``attention_impl`` / ``mlp_impl``
    select the ViT blocks' kernel dispatch (``layers.Block``; the
    ``tpu.*_impl`` config keys); ``remat_policy``: ``tpu.remat_policy``
    (``vit.VisionTransformer``). CNNs ignore the ViT-only arguments."""
    if name in _CNN_PRESETS:
        preset = dict(_CNN_PRESETS[name])
        return _cnn_bundle(name, preset.pop("kind"), preset, img_size, dtype)
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
        kind = ov.pop("kind", "vit")
        if kind in ("convnext", "resnet"):
            return _cnn_bundle(name, kind, ov, img_size, dtype)
        required = ("embed_dim", "depth", "num_heads")
        if kind != "vit" or not all(k in ov for k in required):
            raise KeyError(
                f"unknown model preset {name!r} (and arch_overrides lacks "
                f"{required} for a custom ViT; use kind='convnext'/'resnet' "
                f"with stage kwargs for a custom CNN); available: "
                f"{available_models()}"
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


def _lecun_std(p: torch.Tensor) -> float:
    """lecun-normal's std before truncation: fan_in = p[0].numel() for a
    torch (out, in, ...) weight, the flax kernel's fan in."""
    return math.sqrt(1.0 / p[0].numel()) / 0.87962566103423978


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
    distributions match the reference's, not its random bits). A CNN takes
    flax's defaults (``_init_cnn``) and no fan-in scheme.
    """
    g = torch.Generator().manual_seed(int(seed))
    module = bundle.module
    if not isinstance(module, VisionTransformer):
        if fan_in_init:
            raise ValueError("fan_in_init is the ViT student's scheme; a CNN "
                             "is a teacher and takes flax's defaults")
        _init_cnn(module, g)
        return
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
                    new = _trunc_normal(p.shape, _lecun_std(p), g)
            p.copy_(new.to(p.dtype))


@torch.no_grad()
def _init_cnn(module: torch.nn.Module, g: torch.Generator) -> None:
    """flax's defaults for ConvNeXtV2 / ResNet: conv and Dense kernels
    lecun-normal, biases 0, LayerNorm and BatchNorm scales 1, GRN's gamma
    and beta 0, running mean 0 and variance 1."""
    for name, p in module.named_parameters():
        if ".grn." in name or name.endswith("bias"):
            new = torch.zeros(p.shape)
        elif p.dim() == 1:  # LayerNorm / BatchNorm scale
            new = torch.ones(p.shape)
        else:
            new = _trunc_normal(p.shape, _lecun_std(p), g)
        p.copy_(new)
    for name, buf in module.named_buffers():
        if name.endswith("running_mean") or name.endswith("num_batches_tracked"):
            buf.zero_()
        elif name.endswith("running_var"):
            buf.fill_(1.0)


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
    """The frozen teacher (reference ``load_teacher``), in eval mode, no
    grads. A ViT gets importance 'cls' and collects its per-layer tokens
    into the flat stack; a CNN neither. ``checkpoint_path``: a torch
    state-dict ``.pth`` (timm / dinov2 / torchvision layout), ported by
    ``port.port_torch_checkpoint``; otherwise the teacher is randomly
    initialised from ``seed``. For a name in no preset that comes with a
    checkpoint the architecture is derived from the state dict's shapes
    (``port.derive_arch_from_state_dict``); entries of ``arch_overrides``
    (``basd.teacher_arch``) win over derived ones. ``attention_impl``:
    ``tpu.teacher_attention_impl``."""
    ov = dict(arch_overrides or {})
    sd = None
    if checkpoint_path:
        sd, _ = port.load_state_dict(checkpoint_path)
        if model_name not in _VIT_PRESETS and model_name not in _CNN_PRESETS:
            ov = port.derive_arch_from_state_dict(sd, declared=ov)
            print(f"teacher_arch_derived model={model_name} "
                  + " ".join(f"{k}={v}" for k, v in sorted(ov.items())))
    is_vit = model_name in _VIT_PRESETS or (
        model_name not in _CNN_PRESETS and ov.get("kind", "vit") == "vit")
    bundle = create_model(
        model_name, img_size=img_size, num_classes=0,
        arch_overrides=ov or None, importance_mode="cls" if is_vit else None,
        collect=is_vit, dtype=dtype, attention_impl=attention_impl,
    )
    init_model(bundle, seed)
    if sd is not None:
        port.port_torch_checkpoint(sd, bundle)
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
    the frozen teacher (reference ``extract_intermediates``). A ViT's
    tokens are ``PackedTokens`` for a collecting teacher, else a dense
    stack; ``collection_init``: a reused (L*B*N, D) buffer (fully
    overwritten). A CNN yields one "layer", its last (B, H, W, C) map as
    (1, B, H*W, C) tokens in (h, w) row-major order, with uniform
    importance 1/(H*W) (reference ``teacher.py:184-191``)."""
    if bundle.info["feature_format"] == "token":
        out = bundle.module(x, deterministic=True,
                            collection_init=collection_init)
        return out["tokens"], out["importance"]
    feats = bundle.module(x, deterministic=True)["features"]
    b, h, w, c = feats.shape
    tokens = feats.reshape(b, h * w, c)[None]
    importance = torch.full((1, b, h * w), 1.0 / (h * w), dtype=torch.float32,
                            device=feats.device)
    return tokens, importance


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
