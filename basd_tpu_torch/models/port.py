"""Weights from torch checkpoints and from the JAX package.

Torch checkpoints (counterpart of ``basd_tpu/models/port.py``): the port
keeps timm's and torchvision's key names, so a ``.pth`` needs no
conversion of layout. ``port_torch_checkpoint`` maps what differs (older
DINOv2 LayerScale names, the older ConvNeXtV2 MLP names, a position grid
trained at another image size), drops the keys the reference ignores
(classifier heads, ``mask_token``, ``norm_pre``) and loads the rest with
``load_state_dict(strict=True)``, which raises on any missing key, extra
key or shape mismatch. ``derive_arch_from_state_dict`` reads an unlisted
teacher's architecture from the shapes (``port.py:30-122``);
``interpolate_pos_embed`` resizes a position grid as
``jax.image.resize(..., "linear")`` does (``port.py:125-148``).

The JAX package's trees: ``state_dict_from_jax`` turns a flax ViT
parameter tree (scan-stacked blocks) into this port's module state, the
mapping of ``basd_tpu/models/export.py:32-94``; ``cnn_state_dict_from_jax``
does the same for the ConvNeXtV2 and ResNet trees (``batch_stats``
included), the inverse of ``port.py:232-329``; ``selector_state_from_jax``
the selector's parameter and buffers (``basd_tpu/losses/selector.py:71-90``).
All are re-implemented here (importing the JAX modules would import jax),
so both packages compute the same function from the same weights.

Tensor parallelism (``parallel.mesh``): ``shard_state_dict`` cuts a full
ViT state dict (the one layout, e.g. ``state_dict_from_jax``'s output) down
to one rank's shard of its blocks, ``gather_state_dict`` puts the ranks'
shards back together over the model group: a checkpoint is always the
whole, one-process state.
"""

from __future__ import annotations

import re

import numpy as np
import torch
import torch.distributed as dist

from basd_tpu_torch.parallel.mesh import split_range


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def state_dict_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """Flax ViT params (nested dict of arrays) -> torch state dict:
    block leaves unstacked along axis 0, Dense kernels transposed to
    (out, in), the (C*p*p, D) patch kernel refolded to (D, C, p, p)."""
    blocks = params["blocks"]
    depth = int(np.asarray(blocks["norm1"]["scale"]).shape[0])
    sd: dict[str, torch.Tensor] = {}
    if "cls_token" in params:
        sd["cls_token"] = _t(params["cls_token"])
    sd["pos_embed"] = _t(params["pos_embed"])

    pk = np.asarray(params["patch_embed"]["proj"]["kernel"], np.float32)
    cpp, d_out = pk.shape
    for c in (3, 1):
        p = int(round((cpp / c) ** 0.5))
        if c * p * p == cpp:
            break
    else:
        raise ValueError(f"cannot refold a patch kernel of {cpp} rows")
    sd["patch_embed.proj.weight"] = _t(pk.T.reshape(d_out, c, p, p))
    sd["patch_embed.proj.bias"] = _t(params["patch_embed"]["proj"]["bias"])

    def unstack(path: tuple, fmt: str, transpose: bool = False):
        leaf = blocks
        for k in path:
            leaf = leaf[k]
        arr = np.asarray(leaf, np.float32)
        for i in range(depth):
            sd[fmt.format(i=i)] = _t(arr[i].T if transpose else arr[i])

    unstack(("norm1", "scale"), "blocks.{i}.norm1.weight")
    unstack(("norm1", "bias"), "blocks.{i}.norm1.bias")
    unstack(("attn", "qkv", "kernel"), "blocks.{i}.attn.qkv.weight", True)
    unstack(("attn", "qkv", "bias"), "blocks.{i}.attn.qkv.bias")
    unstack(("attn", "proj", "kernel"), "blocks.{i}.attn.proj.weight", True)
    unstack(("attn", "proj", "bias"), "blocks.{i}.attn.proj.bias")
    unstack(("norm2", "scale"), "blocks.{i}.norm2.weight")
    unstack(("norm2", "bias"), "blocks.{i}.norm2.bias")
    unstack(("mlp", "fc1", "kernel"), "blocks.{i}.mlp.fc1.weight", True)
    unstack(("mlp", "fc1", "bias"), "blocks.{i}.mlp.fc1.bias")
    unstack(("mlp", "fc2", "kernel"), "blocks.{i}.mlp.fc2.weight", True)
    unstack(("mlp", "fc2", "bias"), "blocks.{i}.mlp.fc2.bias")
    if "ls1" in blocks:
        unstack(("ls1", "gamma"), "blocks.{i}.ls1.gamma")
        unstack(("ls2", "gamma"), "blocks.{i}.ls2.gamma")

    sd["norm.weight"] = _t(params["norm"]["scale"])
    sd["norm.bias"] = _t(params["norm"]["bias"])
    if "head" in params:
        sd["head.weight"] = _t(np.asarray(params["head"]["kernel"]).T)
        sd["head.bias"] = _t(params["head"]["bias"])
    return sd


def selector_state_from_jax(params: dict, buffers: dict):
    """JAX selector ``(params, buffers)`` -> the port's: the learnable
    ``log_temperatures`` (P,) and the frozen ``proj_s`` / ``proj_t``."""
    return (
        {"log_temperatures": _t(params["log_temperatures"])},
        {"proj_s": _t(buffers["proj_s"]), "proj_t": _t(buffers["proj_t"])},
    )


def _conv_from_flax(kernel) -> torch.Tensor:
    """flax conv kernel (kh, kw, I, O) -> torch (O, I, kh, kw)."""
    return _t(np.asarray(kernel, np.float32).transpose(3, 2, 0, 1))


def _dense_from_flax(tree: dict, prefix: str) -> dict[str, torch.Tensor]:
    return {f"{prefix}.weight": _t(np.asarray(tree["kernel"]).T),
            f"{prefix}.bias": _t(tree["bias"])}


def _ln_from_flax(tree: dict, prefix: str) -> dict[str, torch.Tensor]:
    return {f"{prefix}.weight": _t(tree["scale"]),
            f"{prefix}.bias": _t(tree["bias"])}


def _bn_from_flax(p: dict, s: dict, prefix: str) -> dict[str, torch.Tensor]:
    return {f"{prefix}.weight": _t(p["scale"]), f"{prefix}.bias": _t(p["bias"]),
            f"{prefix}.running_mean": _t(s["mean"]),
            f"{prefix}.running_var": _t(s["var"]),
            f"{prefix}.num_batches_tracked": torch.tensor(0, dtype=torch.long)}


def cnn_state_dict_from_jax(variables: dict) -> dict[str, torch.Tensor]:
    """The JAX package's ConvNeXtV2 ``{'params'}`` or ResNet ``{'params',
    'batch_stats'}`` (nested dicts of arrays) -> the port's state dict
    (timm / torchvision names and layouts)."""
    params = variables["params"]
    sd: dict[str, torch.Tensor] = {}
    if "stem_norm" in params:  # ConvNeXtV2
        sd["stem.0.weight"] = _conv_from_flax(params["stem_conv"]["kernel"])
        sd["stem.0.bias"] = _t(params["stem_conv"]["bias"])
        sd.update(_ln_from_flax(params["stem_norm"], "stem.1"))
        si = 0
        while f"stage{si}_block0" in params:
            if si > 0:
                pre = f"stages.{si}.downsample"
                sd.update(_ln_from_flax(params[f"downsample_norm{si}"], pre + ".0"))
                conv = params[f"downsample_conv{si}"]
                sd[pre + ".1.weight"] = _conv_from_flax(conv["kernel"])
                sd[pre + ".1.bias"] = _t(conv["bias"])
            bi = 0
            while f"stage{si}_block{bi}" in params:
                blk = params[f"stage{si}_block{bi}"]
                pre = f"stages.{si}.blocks.{bi}"
                sd[pre + ".conv_dw.weight"] = _conv_from_flax(blk["dwconv"]["kernel"])
                sd[pre + ".conv_dw.bias"] = _t(blk["dwconv"]["bias"])
                sd.update(_ln_from_flax(blk["norm"], pre + ".norm"))
                sd.update(_dense_from_flax(blk["pwconv1"], pre + ".mlp.fc1"))
                sd[pre + ".mlp.grn.weight"] = _t(blk["grn"]["gamma"]).reshape(1, 1, 1, -1)
                sd[pre + ".mlp.grn.bias"] = _t(blk["grn"]["beta"]).reshape(1, 1, 1, -1)
                sd.update(_dense_from_flax(blk["pwconv2"], pre + ".mlp.fc2"))
                bi += 1
            si += 1
        return sd
    stats = variables["batch_stats"]  # ResNet
    sd["conv1.weight"] = _conv_from_flax(params["stem_conv"]["kernel"])
    sd.update(_bn_from_flax(params["stem_bn"], stats["stem_bn"], "bn1"))
    for name, blk in params.items():
        m = re.fullmatch(r"layer(\d+)_block(\d+)", name)
        if m is None:
            continue
        pre = f"layer{m.group(1)}.{m.group(2)}"
        for ci in (1, 2, 3):
            sd[f"{pre}.conv{ci}.weight"] = _conv_from_flax(blk[f"conv{ci}"]["kernel"])
            sd.update(_bn_from_flax(blk[f"bn{ci}"], stats[name][f"bn{ci}"],
                                    f"{pre}.bn{ci}"))
        if "downsample_conv" in blk:
            sd[f"{pre}.downsample.0.weight"] = _conv_from_flax(
                blk["downsample_conv"]["kernel"])
            sd.update(_bn_from_flax(blk["downsample_bn"],
                                    stats[name]["downsample_bn"],
                                    f"{pre}.downsample.1"))
    return sd


# -- torch checkpoints -----------------------------------------------------


def load_state_dict(path: str) -> tuple[dict[str, torch.Tensor], int]:
    """A ``.pth`` state dict, unwrapped from ``{'model_state_dict': ...}``
    (the exports of both packages) or ``{'state_dict': ...}``, and the
    epoch the wrapper records (-1 when it records none)."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    epoch = int(obj.get("epoch", -1)) if isinstance(obj, dict) else -1
    if isinstance(obj, dict) and "model_state_dict" in obj:
        obj = obj["model_state_dict"]
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return dict(obj), epoch


def _block_count(sd: dict, prefix: str) -> int:
    idx = [int(m.group(1)) for k in sd
           if (m := re.match(rf"{re.escape(prefix)}\.(\d+)\.", k))]
    return max(idx) + 1 if idx else 0


def derive_arch_from_state_dict(sd: dict, declared: dict | None = None) -> dict:
    """Architecture facts from a state dict's tensor shapes (reference
    ``port.derive_arch_from_state_dict``): a timm/dinov2 ViT (embed_dim and
    patch size from the patch conv, depth, mlp_ratio, LayerScale and CLS
    from key presence, num_heads by the head_dim 64/48/32/96/128 rule), a
    ConvNeXtV2 (depths, dims) or a bottleneck ResNet (stage_sizes, width).
    A ViT whose fc1 has twice fc2's inputs (or DINOv2's ``w12``) is SwiGLU,
    with ``mlp_hidden`` fc2's inputs. ``declared`` entries
    (``basd.teacher_arch``) win over derived ones."""
    declared = dict(declared or {})
    if "patch_embed.proj.weight" in sd and "blocks.0.norm1.weight" in sd:
        d, _c, p, _ = sd["patch_embed.proj.weight"].shape
        d = int(d)
        sd = {_mlp_key(k): v for k, v in sd.items()}
        fc1 = int(sd["blocks.0.mlp.fc1.weight"].shape[0])
        hidden = int(sd["blocks.0.mlp.fc2.weight"].shape[1])
        arch: dict = {
            "kind": "vit",
            "embed_dim": d,
            "depth": _block_count(sd, "blocks"),
            "patch_size": int(p),
            "mlp_ratio": float(hidden) / d,
            "use_cls_token": "cls_token" in sd,
        }
        if fc1 == 2 * hidden:
            arch.update(mlp="swiglu", mlp_hidden=hidden)
        if "blocks.0.ls1.gamma" in sd or "blocks.0.gamma_1" in sd:
            # the value is overwritten by the checkpoint's gammas
            arch["layerscale_init"] = 1e-5
        if "num_heads" not in declared:
            for head_dim in (64, 48, 32, 96, 128):
                if d % head_dim == 0:
                    arch["num_heads"] = d // head_dim
                    break
            else:
                raise ValueError(
                    f"cannot infer num_heads for embed_dim={d}; declare "
                    "basd.teacher_arch.num_heads")
    elif "stem.0.weight" in sd and "stages.0.blocks.0.conv_dw.weight" in sd:
        n_stages = 1 + max(int(k.split(".")[1]) for k in sd
                           if k.startswith("stages."))
        arch = {
            "kind": "convnext",
            "depths": tuple(_block_count(sd, f"stages.{i}.blocks")
                            for i in range(n_stages)),
            "dims": tuple(int(sd[f"stages.{i}.blocks.0.conv_dw.weight"].shape[0])
                          for i in range(n_stages)),
        }
    elif "conv1.weight" in sd and "layer1.0.conv1.weight" in sd:
        sizes = []
        while f"layer{len(sizes) + 1}.0.conv1.weight" in sd:
            sizes.append(_block_count(sd, f"layer{len(sizes) + 1}"))
        arch = {"kind": "resnet", "stage_sizes": tuple(sizes),
                "width": int(sd["conv1.weight"].shape[0])}
    else:
        raise ValueError(
            "unrecognized state-dict layout: expected timm/dinov2 ViT "
            "(patch_embed.proj + blocks.*), ConvNeXtV2 (stem + stages.*), "
            "or ResNet (conv1 + layer*) keys")
    arch.update(declared)
    return arch


def _linear_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) weights of ``jax.image.resize``'s "linear" method
    along one axis (``jax/_src/image/scale.py:compute_weight_mat``):
    half-pixel sample points, a triangle kernel widened by the scale when
    downsampling (antialias), columns normalised, f32 as there."""
    f32 = np.float32
    inv_scale = f32(1.0) / f32(n_out / n_in)
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def interpolate_pos_embed(pos, target_tokens: int,
                          has_cls: bool = True) -> torch.Tensor:
    """Resize a (1, [1 +] n*n, D) position grid to ``target_tokens`` patch
    positions (CLS slot kept), for a checkpoint trained at another image
    size (DINOv2's 37 x 37 grid onto 224 / 14 = 16 x 16): separable linear
    resampling with antialiasing, the arithmetic of the reference's
    ``jax.image.resize(..., "linear")``."""
    pos = torch.as_tensor(pos).float()
    n_src = pos.shape[1] - (1 if has_cls else 0)
    if n_src == target_tokens:
        return pos
    side_src = int(round(n_src ** 0.5))
    side_dst = int(round(target_tokens ** 0.5))
    head, grid = (pos[:, :1], pos[:, 1:]) if has_cls else (pos[:, :0], pos)
    grid = grid.reshape(side_src, side_src, -1).double()
    w = torch.from_numpy(_linear_resize_matrix(side_src, side_dst)).double()
    resized = torch.einsum("hwd,hy,wx->yxd", grid, w, w).float()
    return torch.cat([head, resized.reshape(1, side_dst * side_dst, -1)], dim=1)


# DINOv2's hub names of a SwiGLU MLP -> timm's: w12 (fc1, packed [a | g],
# as timm's SwiGLUPacked keeps it) and w3 (fc2)
_DINOV2_MLP = {"w12": "fc1", "w3": "fc2"}


def _mlp_key(k: str) -> str:
    return re.sub(r"^(blocks\.\d+\.mlp)\.(w12|w3)\.",
                  lambda m: f"{m.group(1)}.{_DINOV2_MLP[m.group(2)]}.", k)


# keys of real checkpoints the reference ignores (a classifier head, DINOv2's
# mask token, timm ConvNeXt's pre-head norm)
_IGNORED = re.compile(r"^(head|fc)\.|^mask_token$|^norm_pre\.")
# the ConvNeXtV2 release's block names -> timm's
_CONVNEXT_OLD = {"grn": "mlp.grn", "pwconv1": "mlp.fc1", "pwconv2": "mlp.fc2"}


def port_torch_checkpoint(sd: dict, bundle) -> None:
    """Load a timm / dinov2 / torchvision state dict into ``bundle.module``
    in place: DINOv2's ``blocks.{i}.gamma_{1,2}`` become ``ls{1,2}.gamma``
    and its SwiGLU ``mlp.w12`` / ``mlp.w3`` timm's ``mlp.fc1`` / ``mlp.fc2``,
    the older ConvNeXtV2 ``grn`` / ``pwconv{1,2}`` names ``mlp.grn`` /
    ``mlp.fc{1,2}`` (GRN reshaped to the model's), ``pos_embed`` is resized
    to the model's grid, a ResNet checkpoint without ``num_batches_tracked``
    keeps the model's, and the keys the reference ignores are dropped
    (a head the model lacks, ``mask_token``, ``norm_pre``). The rest loads
    strictly: a missing key, an unknown key or a shape mismatch raises."""
    module = bundle.module
    own = module.state_dict()
    out: dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        if _IGNORED.match(k) and k not in own:
            continue
        k = re.sub(r"^(blocks\.\d+)\.gamma_([12])$", r"\1.ls\2.gamma", k)
        k = _mlp_key(k)
        k = re.sub(r"^(stages\.\d+\.blocks\.\d+)\.(grn|pwconv1|pwconv2)\.",
                   lambda m: f"{m.group(1)}.{_CONVNEXT_OLD[m.group(2)]}.", k)
        v = torch.as_tensor(v)
        if k == "pos_embed" and k in own:
            has_cls = "cls_token" in sd
            v = interpolate_pos_embed(v, own[k].shape[1] - int(has_cls), has_cls)
        elif ".mlp.grn." in k and k in own:
            v = v.reshape(own[k].shape)
        out[k] = v
    for k, v in own.items():
        if k.endswith("num_batches_tracked") and k not in out:
            out[k] = v
    module.load_state_dict(out, strict=True)


# the block parameters a tensor-parallel rank holds a shard of: column-
# parallel qkv and fc1 (rows, with their biases), row-parallel proj and fc2
# (columns); every other key is replicated
_TP_KEY = re.compile(r"(?:^|\.)blocks\.\d+\.(attn\.qkv\.weight|attn\.qkv\.bias|"
                     r"attn\.proj\.weight|mlp\.fc1\.weight|mlp\.fc1\.bias|"
                     r"mlp\.fc2\.weight)$")


def tp_key(key: str) -> str | None:
    """Which sharded block parameter ``key`` names (``'attn.qkv.weight'``
    ...), or None for a replicated one; any prefix (``'student.'``)."""
    m = _TP_KEY.search(key)
    return m.group(1) if m else None


def _tp_pieces(kind: str, rank_world, num_heads: int, dim: int, hidden: int):
    """The (axis, [(start, stop), ...]) of the full tensor that rank
    ``(rank, world)`` holds, in its shard's order: its heads' rows of q,
    k and v, its heads' columns of proj, its hidden units' rows of fc1 and
    columns of fc2."""
    rank, world = rank_world
    if kind.startswith("attn"):
        e = dim // num_heads
        h0, h1 = split_range(num_heads, world, rank)
        if kind == "attn.proj.weight":
            return 1, [(h0 * e, h1 * e)]
        return 0, [(p * dim + h0 * e, p * dim + h1 * e) for p in range(3)]
    f0, f1 = split_range(hidden, world, rank)
    return (1 if kind == "mlp.fc2.weight" else 0), [(f0, f1)]


def shard_state_dict(sd: dict, tp, num_heads: int) -> dict:
    """A full ViT state dict (keys of any prefix) -> this rank's: qkv
    weight rows (3 h E, D) and bias of its heads of q, then k, then v;
    proj weight columns (D, h E); fc1 weight rows (F_r, D) and bias; fc2
    weight columns (D, F_r); every other entry as it is (the same
    tensor). A SwiGLU block's packed [a | g] fc1 (2 F rows to fc2's F
    columns) raises: it is not sharded."""
    out = {}
    for key, t in sd.items():
        kind = tp_key(key)
        if kind is None:
            out[key] = t
            continue
        if kind == "mlp.fc1.weight":
            fc2 = sd.get(key[:-len("fc1.weight")] + "fc2.weight")
            if fc2 is not None and t.shape[0] == 2 * fc2.shape[1]:
                raise ValueError(
                    f"tensor parallelism does not shard a SwiGLU block: "
                    f"{key} packs [a | g], {tuple(t.shape)}")
        dim = t.shape[-1] if kind == "attn.qkv.weight" else None
        dim = dim or (t.shape[0] // 3 if kind == "attn.qkv.bias"
                      else t.shape[0])
        hidden = t.shape[1] if kind == "mlp.fc2.weight" else t.shape[0]
        axis, pieces = _tp_pieces(kind, (tp.rank, tp.world), num_heads, dim,
                                  hidden)
        out[key] = torch.cat([t.narrow(axis, a, b - a) for a, b in pieces],
                             axis).contiguous()
    return out


def gather_state_dict(sd: dict, tp, num_heads: int, dim: int,
                      hidden: int) -> dict:
    """The inverse of ``shard_state_dict`` over the model group: every
    rank's shard of each sharded entry (all-gathered, padded to the largest
    shard), put back in rank order into the full tensor, bit for bit; the
    replicated entries as they are. Every rank of the group must call it,
    with the same keys in the same order."""
    out = {}
    for key, t in sd.items():
        kind = tp_key(key)
        if kind is None or tp.world == 1:
            out[key] = t
            continue
        layouts = [_tp_pieces(kind, (r, tp.world), num_heads, dim, hidden)
                   for r in range(tp.world)]
        axis = layouts[0][0]
        sizes = [sum(b - a for a, b in pieces) for _, pieces in layouts]
        pad = list(t.shape)
        pad[axis] = max(sizes)
        mine = torch.zeros(pad, dtype=t.dtype, device=t.device)
        mine.narrow(axis, 0, t.shape[axis]).copy_(t)
        parts = [torch.empty_like(mine) for _ in range(tp.world)]
        dist.all_gather(parts, mine, group=tp.group)
        full_shape = list(t.shape)
        full_shape[axis] = (3 * dim if kind.startswith("attn.qkv")
                            else dim if kind == "attn.proj.weight" else hidden)
        full = torch.empty(full_shape, dtype=t.dtype, device=t.device)
        for part, (_, pieces) in zip(parts, layouts):
            i = 0
            for a, b in pieces:
                full.narrow(axis, a, b - a).copy_(part.narrow(axis, i, b - a))
                i += b - a
        out[key] = full
    return out
