"""Weights carried across from the JAX package.

``state_dict_from_jax`` turns a flax ViT parameter tree (scan-stacked
blocks) into this port's module state, which keeps timm's names and
layouts; the mapping is that of ``basd_tpu/models/export.py:32-94``
(re-implemented here: importing that module would import jax).
``selector_state_from_jax`` does the same for the selector's parameter and
buffers (``basd_tpu/losses/selector.py:71-90``), so both packages compute
the same function from the same weights.
"""

from __future__ import annotations

import numpy as np
import torch


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
