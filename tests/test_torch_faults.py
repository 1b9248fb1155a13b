"""Dispatch rules of the port's ``Block`` and ``Attention`` against the
reference's, where they once differed.

- An f32 block with an explicit ``mlp_impl='fused_ln'`` runs K4's plain
  version in the block's dtype (the reference casts the MLP weights to
  ``self.dtype``): its logits match the JAX package's within 1e-5 of
  max(|ref|, 1), f32 rounding. On CUDA the same block takes K2/K4's f32
  entries; ``block_mlp_path`` is the rule, called here as a pure function
  because the CPU has no CUDA tensor. K2/K4's plain versions at f32 match
  the reference's f32 Pallas kernels (in interpret mode) within 1e-5
  relative: both keep every value in f32 and differ only in the order of
  their sums.
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
    ("fused_ln", True, torch.float32, "fused_ln"),    # K2 / K4 at f32
])
def test_block_mlp_path(impl, is_cuda, dtype, expected):
    assert block_mlp_path(impl, is_cuda, dtype, 3) == expected


def _f32(shape, scale=1.0, offset=0.0):
    """The same f32 values as a jax array and a torch tensor."""
    a = (RNG.standard_normal(shape) * scale + offset).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _close(a, r, what):
    a, r = np.asarray(a, dtype=np.float32), np.asarray(r, dtype=np.float32)
    assert a.shape == r.shape, what
    err = np.abs(a - r).max()
    assert err <= 1e-5 * max(np.abs(r).max(), 1.0), f"{what}: {err}"


def test_f32_block_mlp_plain_matches_jax_fused_ln_mlp():
    """K2/K4's plain versions at f32 (what their _f32 CUDA entries compute)
    against the reference's f32 Pallas ``fused_ln_mlp`` / ``_bwd`` and
    ``fused_ln_mlp_collect`` in interpret mode, B=2, N=5, D=16, F=64:
    within 1e-5 of max(|ref|, 1)."""
    from basd_tpu.ops.pallas import fused_block_mlp as jfbm
    from basd_tpu_torch.kernels import block_mlp

    b, n, d, f, eps = 2, 5, 16, 64, 1e-6
    x, ln_s, ln_b = _f32((b, n, d)), _f32((d,), 0.1, 1.0), _f32((d,), 0.1)
    w1, b1 = _f32((d, f), d ** -0.5), _f32((f,), 0.1)  # JAX (in, out)
    w2, b2 = _f32((f, d), f ** -0.5), _f32((d,), 0.1)
    m = np.array([1.25, 0.0], dtype=np.float32)
    mask = (jnp.asarray(m), torch.from_numpy(m))
    dout = _f32((b, n, d))
    w1t, w2t = w1[1].t().contiguous(), w2[1].t().contiguous()

    j_out = jfbm._fwd(x[0], mask[0], ln_s[0], ln_b[0], w1[0], b1[0], w2[0],
                      b2[0], eps, True)
    out = block_mlp.block_mlp_plain(x[1], mask[1], ln_s[1], ln_b[1], w1t,
                                    b1[1], w2t, b2[1], eps)
    assert out.dtype == torch.float32
    _close(out.numpy(), j_out, "f32 K4a out")

    layers, idx = 3, 1
    buf = _f32((layers * b * n, d))
    j_out, j_buf = jfbm.fused_ln_mlp_collect(
        x[0], mask[0], ln_s[0], ln_b[0], w1[0], b1[0], w2[0], b2[0], buf[0],
        idx, eps, True)
    buf_t = buf[1].clone()
    out = block_mlp.fused_ln_mlp_collect(x[1], mask[1], ln_s[1], ln_b[1], w1t,
                                         b1[1], w2t, b2[1], buf_t, idx, eps)
    _close(out.numpy(), j_out, "f32 K2 out")
    _close(buf_t.numpy(), j_buf, "f32 K2 collection buffer")

    j_grads = jfbm._bwd(x[0], mask[0], dout[0], ln_s[0], ln_b[0], w1[0],
                        b1[0], w2[0], eps, True)
    grads = block_mlp.block_mlp_plain_bwd(x[1], mask[1], dout[1], ln_s[1],
                                          ln_b[1], w1t, b1[1], w2t, eps)
    assert grads[0].dtype == torch.float32
    for i, (g, jg) in enumerate(zip(grads, j_grads)):
        jg = np.asarray(jg)
        jg = jg.T if i in (1, 3) else jg.reshape(g.shape)  # (in, out) -> (out, in)
        _close(g.numpy(), jg, f"f32 K4b output {i}")


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
