"""Dispatch rules of the port's ``Block`` and ``Attention`` against the
reference's, where they once differed.

- An f32 block with an explicit ``mlp_impl='fused_ln'`` runs K4's plain
  version in the block's dtype (the reference casts the MLP weights to
  ``self.dtype``): its logits match the JAX package's within 1e-5 of
  max(|ref|, 1), f32 rounding. On CUDA the same block raises, since K2/K4
  are bf16 kernels; ``block_mlp_path`` is the rule, called here as a pure
  function because the CPU has no CUDA tensor.
- ``attention_impl='auto'`` takes K10 (``flash``) on CUDA at any dtype,
  as the reference takes it on its accelerator, and einsum elsewhere.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from basd_tpu.models.vit import ViTConfig as JViTConfig
from basd_tpu.models.vit import VisionTransformer as JViT
from basd_tpu_torch.models.layers import attention_auto_impl, block_mlp_path
from basd_tpu_torch.models.port import state_dict_from_jax
from basd_tpu_torch.models.vit import ViTConfig, VisionTransformer

RNG = np.random.default_rng(61)


def test_f32_fused_ln_vit_matches_jax():
    cfg_kw = dict(img_size=32, patch_size=8, num_classes=10, embed_dim=64,
                  depth=2, num_heads=2)
    impl = dict(attention_impl="module", mlp_impl="fused_ln")
    x = RNG.standard_normal((4, 32, 32, 3)).astype(np.float32)
    jm = JViT(JViTConfig(**cfg_kw), **impl)
    params = jm.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x))
    ref = np.array(jm.apply(params, jnp.asarray(x))["logits"])
    model = VisionTransformer(ViTConfig(**cfg_kw), **impl)
    model.load_state_dict(state_dict_from_jax(params["params"]))
    with torch.no_grad():
        out = model(torch.from_numpy(x))["logits"].numpy()
    assert out.shape == ref.shape
    err = np.abs(out - ref).max()
    assert err <= 1e-5 * max(np.abs(ref).max(), 1.0), err


@pytest.mark.parametrize("impl,is_cuda,dtype,expected", [
    ("fused_ln", False, torch.float32, "fused_ln"),   # plain version, f32
    ("fused_ln", True, torch.bfloat16, "fused_ln"),   # K2 / K4
    ("auto", True, torch.bfloat16, "fused_ln"),
    ("auto", True, torch.float32, "auto"),            # the module chain
    ("auto", False, torch.bfloat16, "auto"),
    ("module", True, torch.float32, "module"),
    ("fused_ln", True, torch.float32, NotImplementedError),
])
def test_block_mlp_path(impl, is_cuda, dtype, expected):
    if expected is NotImplementedError:
        with pytest.raises(NotImplementedError,
                           match="f32 fused_ln on CUDA: K2/K4 are bf16"):
            block_mlp_path(impl, is_cuda, dtype, 3)
    else:
        assert block_mlp_path(impl, is_cuda, dtype, 3) == expected


@pytest.mark.parametrize("is_cuda,expected", [(True, "flash"),
                                              (False, "einsum")])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_auto_impl(is_cuda, expected, dtype):
    """The rule does not look at the dtype: f32 slabs on CUDA take K10
    too. ``Attention`` on a CPU tensor of either dtype then takes einsum,
    which equals the flash path's plain version to rounding."""
    assert attention_auto_impl(is_cuda) == expected
    from basd_tpu_torch.models.layers import Attention

    torch.manual_seed(0)
    attn = Attention(32, 4, dtype=dtype)
    x = torch.randn(2, 5, 32).to(dtype)
    auto, _ = attn(x)
    einsum, _ = attn(x, "einsum")
    assert torch.equal(auto, einsum)
