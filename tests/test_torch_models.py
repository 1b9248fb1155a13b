"""The port's ViT against the JAX package's, from the same flax weights
carried across by ``models.port.state_dict_from_jax``: the f32 student with
injected stochastic-depth draws, and the bf16 frozen teacher (K1/K2 plain
versions, packed collection) against the JAX fused teacher in interpret
mode."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from basd_tpu.models.vit import ViTConfig as JViTConfig
from basd_tpu.models.vit import VisionTransformer as JViT
from basd_tpu_torch.models.port import state_dict_from_jax
from basd_tpu_torch.models.vit import ViTConfig, VisionTransformer

RNG = np.random.default_rng(5)
KW = dict(img_size=32, patch_size=8, num_classes=10)


def _jax_params(module, x, seed=0, **rngs):
    return module.init({"params": jax.random.PRNGKey(seed), **rngs}, x)


def _port(cfg_kw, params, **kw):
    model = VisionTransformer(ViTConfig(**cfg_kw), **kw)
    model.load_state_dict(state_dict_from_jax(params["params"]))
    return model


def _f32(a):
    return np.array(jnp.asarray(a).astype(jnp.float32))


def _fixed_bernoulli(key, p, shape):
    """Stand-in for jax.random.bernoulli: a deterministic (B,) draw from the
    keep probability alone, so the test knows every layer's mask."""
    u = jnp.arange(shape[0], dtype=jnp.float32).reshape(shape) * 0.618034
    return jnp.mod(u + p * 7.31, 1.0) < p


@pytest.mark.parametrize("layerscale", [None, 0.5])
def test_f32_vit_matches_jax_with_drop_masks(monkeypatch, layerscale):
    cfg_kw = dict(KW, embed_dim=32, depth=4, num_heads=4, drop_path_rate=0.5,
                  layerscale_init=layerscale)
    x = RNG.standard_normal((8, 32, 32, 3)).astype(np.float32)
    jm = JViT(JViTConfig(**cfg_kw), importance_mode="cls")
    params = _jax_params(jm, jnp.asarray(x))
    monkeypatch.setattr(jax.random, "bernoulli", _fixed_bernoulli)
    ref = jm.apply(params, jnp.asarray(x), deterministic=False,
                   rngs={"droppath": jax.random.PRNGKey(1)})
    # the same draws, computed the way the patched bernoulli computes them
    rates = jnp.asarray(np.linspace(0.0, 0.5, 4), jnp.float32)
    keeps = 1.0 - rates
    masks = np.stack([np.asarray(_fixed_bernoulli(None, k, (8, 1, 1))).reshape(8)
                      for k in keeps])
    assert 0 < masks.sum() < masks.size
    drop = torch.from_numpy(np.stack([masks, masks], axis=1))  # (L, 2, B)
    monkeypatch.undo()

    model = _port(cfg_kw, params, importance_mode="cls")
    out = model(torch.from_numpy(x), deterministic=False, drop_masks=drop)
    for k in ("logits", "tokens", "importance"):
        a, r = out[k].detach().numpy(), _f32(ref[k])
        assert a.shape == r.shape, k
        assert np.abs(a - r).max() <= 1e-4 * max(np.abs(r).max(), 1.0), k


def test_f32_vit_matches_jax_deterministic_remat():
    cfg_kw = dict(KW, embed_dim=32, depth=4, num_heads=4)
    x = RNG.standard_normal((4, 32, 32, 3)).astype(np.float32)
    jm = JViT(JViTConfig(**cfg_kw), remat=True)
    params = _jax_params(jm, jnp.asarray(x))
    ref = jm.apply(params, jnp.asarray(x))
    model = _port(cfg_kw, params, remat=True)
    out = model(torch.from_numpy(x))
    for k in ("logits", "tokens"):
        a, r = out[k].detach().numpy(), _f32(ref[k])
        assert np.abs(a - r).max() <= 1e-4 * max(np.abs(r).max(), 1.0), k


def test_bf16_teacher_matches_jax_fused_teacher():
    """Whole frozen teacher: K1 then K2 per block (plain versions on the
    CPU), layers collected into one flat stack, against the JAX teacher
    with fused_block / fused_ln / collect_alias in interpret mode."""
    cfg_kw = dict(KW, embed_dim=64, depth=4, num_heads=4, num_classes=0)
    xj = jnp.asarray(RNG.standard_normal((8, 32, 32, 3)).astype(np.float32)
                     ).astype(jnp.bfloat16)
    jm = JViT(JViTConfig(**cfg_kw), importance_mode="cls",
              dtype=jnp.bfloat16, attention_impl="fused_block",
              mlp_impl="fused_ln", collect_alias=True)
    params = _jax_params(jm, xj)
    ref = jm.apply(params, xj)
    model = _port(cfg_kw, params, importance_mode="cls", collect=True,
                  dtype=torch.bfloat16, attention_impl="fused_block",
                  mlp_impl="fused_ln")
    buf = torch.full((4 * 8 * 17, 64), 9.0, dtype=torch.bfloat16)
    with torch.no_grad():
        out = model(torch.from_numpy(_f32(xj)).to(torch.bfloat16),
                    collection_init=buf)
    tok = out["tokens"]
    assert tok.flat.data_ptr() == buf.data_ptr()  # written in place
    pairs = (
        (tok.to_dense(), ref["tokens"].to_dense()),
        (tok.cls, ref["tokens"].cls),
        (out["logits"], ref["logits"]),
    )
    for a, r in pairs:
        a, r = a.float().numpy(), _f32(r)
        assert a.shape == r.shape
        assert np.abs(a - r).max() <= 2 ** -5 * max(np.abs(r).max(), 1.0)
    ia, ib = out["importance"].numpy(), _f32(ref["importance"])
    assert np.abs(ia - ib).max() <= 2e-2 * ib.max()


def test_state_dict_from_jax_round_trips_export():
    """The port's mapping equals the JAX package's timm export."""
    from basd_tpu.models.export import vit_state_dict_from_params

    cfg_kw = dict(KW, embed_dim=32, depth=2, num_heads=4, layerscale_init=0.1)
    jm = JViT(JViTConfig(**cfg_kw))
    params = _jax_params(jm, jnp.zeros((1, 32, 32, 3)))
    ours = state_dict_from_jax(params["params"])
    theirs = vit_state_dict_from_params(params["params"])
    assert set(ours) == set(theirs)
    for k in ours:
        np.testing.assert_array_equal(ours[k].numpy(), theirs[k])
    model = VisionTransformer(ViTConfig(**cfg_kw))
    assert set(model.state_dict()) == set(ours)
