"""The module-chain kernels of the port, K10 (attention over the packed qkv
slab, with its backward and the forward-only importance variant) and K11
(the fused MLP and its backward), against the JAX package's Pallas kernels
in interpret mode on the same numpy inputs; the ``Attention`` / ``Mlp`` /
``Block`` dispatch of ``flash`` and ``fused``; whole bf16 models on those
impls in both packages; the CLI with the three overrides; and the
``tpu.remat_policy`` values.

On CPU tensors the wrappers run their plain versions, so these tests hold
the plain versions (and the autograd functions around them) to the
reference; chip_smoke.py holds the CUDA kernels to the plain versions on
the card.

Tolerances: f32 outputs within 5e-6 absolute (``tests/test_flash_attention
.py``'s bound for the same kernel) and f32 gradients within 1e-5 of the
leaf max; bf16 outputs and dx within 2^-5 * max(|ref|, 1) (one bf16
rounding of the largest value); f32 gradients of the kernels' own outputs
within 1e-3 of the leaf max; weight gradients returned in the bf16 weights'
dtype within an ulp (2^-7) of the leaf max; lse within 1e-5 of
max(|ref|, 1); the importance within 1e-6 absolute (f32 softmax rows, as
``tests/test_flash_attention.py`` holds the JAX package's). Gradients
through whole models in two frameworks whose bf16 roundings differ by an
ulp in places are held to 2^-5 of each leaf's max.
"""

from __future__ import annotations

import json
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from basd_tpu_torch.kernels import flash_attention as fa
from basd_tpu_torch.kernels import fused_mlp as fm

RNG = np.random.default_rng(23)
BF16_ULP = 2 ** -7


def _pair(shape, dtype, scale=1.0):
    """The same values as a jax array and a torch tensor, in ``dtype``."""
    a = (RNG.standard_normal(shape) * scale).astype(np.float32)
    j = jnp.asarray(a).astype(jnp.dtype(dtype))
    t = torch.from_numpy(np.array(j.astype(jnp.float32)))
    return j, t.to(getattr(torch, dtype))


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.array(jnp.asarray(t).astype(jnp.float32))


def _close(a, r, rel, floor=0.0, what=""):
    a, r = _np(a), _np(r)
    assert a.shape == r.shape, what
    err = np.abs(a - r).max()
    scale = max(np.abs(r).max(), floor)
    assert err <= rel * scale, f"{what}: {err} > {rel} * {scale}"


def _out_close(a, r, dtype, what):
    """Outputs: 5e-6 absolute at f32, 2^-5 of max(|ref|, 1) at bf16."""
    if dtype == "float32":
        _close(a, r, 5e-6, 1.0, what)
    else:
        _close(a, r, 2 ** -5, 1.0, what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,h", [(13, 2), (13, 3), (17, 2), (17, 3)])
def test_k10_forward_matches_jax(dtype, n, h):
    from basd_tpu.ops.pallas import flash_attention as jfa

    b, e = 3, 16
    qkv = _pair((b, n, 3 * h * e), dtype)
    scale = float(e ** -0.5)
    j_o, j_lse = jfa._fwd(qkv[0], n, h, e, scale, True)
    o, lse = fa.flash_attention_fwd(qkv[1], h, scale)
    _out_close(o, j_o, dtype, "K10a o")
    _close(lse, j_lse, 1e-5, 1.0, "K10a lse")
    _out_close(fa.flash_attention_qkv(qkv[1], h, scale),
               jfa.flash_attention_qkv(qkv[0], h, scale, True), dtype,
               "flash_attention_qkv")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h", [2, 3, 4])
def test_k10_importance_matches_jax(dtype, h):
    """Even h takes the head-pair kernel, odd h the head-loop kernel."""
    from basd_tpu.ops.pallas import flash_attention as jfa

    b, n, e = 3, 17, 16
    qkv = _pair((b, n, 3 * h * e), dtype)
    scale = float(e ** -0.5)
    j_o, j_imp = jfa.flash_attention_qkv_with_importance(qkv[0], h, scale,
                                                         True)
    o, imp = fa.flash_attention_imp(qkv[1], h, scale)
    _out_close(o, j_o, dtype, "K10c o")
    assert imp.dtype == torch.float32
    np.testing.assert_allclose(_np(imp), _np(j_imp), rtol=0, atol=1e-6)
    o2, imp2 = fa.flash_attention_qkv_with_importance(qkv[1], h, scale)
    assert torch.equal(o2, o) and torch.equal(imp2, imp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k10_backward_matches_jax(dtype):
    from basd_tpu.ops.pallas import flash_attention as jfa

    b, n, h, e = 3, 17, 3, 16
    qkv = _pair((b, n, 3 * h * e), dtype)
    cot = _pair((b, n, h * e), dtype)
    scale = float(e ** -0.5)

    # the kernel: dqkv from qkv, the saved o, do and lse
    j_o, j_lse = jfa._fwd(qkv[0], n, h, e, scale, True)
    j_dqkv = jfa._bwd(qkv[0], j_o, cot[0], j_lse, n, h, e, scale, True)
    o, lse = fa.flash_attention_fwd(qkv[1], h, scale)
    dqkv = fa.flash_attention_bwd(qkv[1], o, cot[1], lse, h, scale)
    assert dqkv.dtype == qkv[1].dtype
    rel = 1e-5 if dtype == "float32" else 2 ** -5
    _close(dqkv, j_dqkv, rel, 1.0, "K10b dqkv")

    # the differentiable function, through jax.vjp and torch.autograd
    ref, vjp = jax.vjp(lambda q: jfa.flash_attention_qkv(q, h, scale, True),
                       qkv[0])
    leaf = qkv[1].clone().requires_grad_(True)
    out = fa.flash_attention_qkv(leaf, h, scale)
    _out_close(out, ref, dtype, "K10 out")
    out.backward(cot[1])
    _close(leaf.grad, vjp(cot[0])[0], rel, 1.0, "K10 dqkv")


def test_k10_importance_backward_raises():
    qkv = _pair((2, 9, 3 * 32), "float32")[1].requires_grad_(True)
    o, imp = fa.flash_attention_qkv_with_importance(qkv, 2, 0.25)
    with pytest.raises(NotImplementedError, match="forward-only"):
        (o.sum() + imp.sum()).backward()


@pytest.mark.parametrize("dtype,b,n", [("bfloat16", 8, 13), ("bfloat16", 6, 9),
                                       ("float32", 8, 13)])
def test_k11_matches_jax(dtype, b, n):
    """Forward and all five gradients; the f32 path is tanh-GELU too."""
    from basd_tpu.ops.pallas import fused_mlp as jfm

    d, f = 32, 128
    x = _pair((b, n, d), dtype)
    w1 = _pair((d, f), dtype, 0.1)  # JAX (in, out) layout
    b1 = _pair((f,), "float32", 0.1)
    w2 = _pair((f, d), dtype, 0.1)
    b2 = _pair((d,), "float32", 0.1)
    cot = _pair((b, n, d), dtype)
    t_w1, t_w2 = w1[1].t().contiguous(), w2[1].t().contiguous()
    rel = 1e-5 if dtype == "float32" else 2 ** -5

    j_out = jfm.fused_mlp(x[0], w1[0], b1[0], w2[0], b2[0], True)
    out = fm.fused_mlp_fwd(x[1], t_w1, b1[1], t_w2, b2[1])
    _close(out, j_out, rel, 1.0, "K11a out")
    j_grads = jfm._bwd(x[0], cot[0], w1[0], b1[0].reshape(1, -1), w2[0], True)
    grads = fm.fused_mlp_bwd(x[1], cot[1], t_w1, b1[1], t_w2)
    _close(grads[0], j_grads[0], rel, 1.0, "K11b dx")
    for i, (g, jg) in enumerate(zip(grads[1:], j_grads[1:]), 1):
        assert g.dtype == torch.float32
        jg = np.asarray(jg)
        jg = jg.T if i in (1, 3) else jg.reshape(-1)  # (in, out) -> (out, in)
        _close(g, jg, 1e-3 if dtype == "bfloat16" else 1e-5,
               what=f"K11b grad {i}")

    ref, vjp = jax.vjp(lambda *a: jfm.fused_mlp(*a, True),
                       x[0], w1[0], b1[0], w2[0], b2[0])
    leaves = [t.clone().requires_grad_(True)
              for t in (x[1], t_w1, b1[1], t_w2, b2[1])]
    out = fm.fused_mlp(*leaves)
    _close(out, ref, rel, 1.0, "K11 out")
    out.backward(cot[1])
    for i, (jg, leaf) in enumerate(zip(vjp(cot[0]), leaves)):
        g = leaf.grad.t() if i in (1, 3) else leaf.grad
        assert g.dtype == leaf.dtype
        if i == 0:
            _close(g, jg, rel, 1.0, "K11 dx")
        elif leaf.dtype == torch.bfloat16:
            _close(g, jg, BF16_ULP, what=f"K11 grad {i}")
        else:
            _close(g, jg, 1e-3 if dtype == "bfloat16" else 1e-5,
                   what=f"K11 grad {i}")


def _block0(tree):
    """Layer 0 of a scan-stacked flax subtree."""
    return jax.tree_util.tree_map(lambda a: a[0], tree)


@pytest.mark.parametrize("mode", [None, "cls"])
def test_attention_flash_and_mlp_fused_modules_match_flax(mode):
    """``Attention('flash')`` and ``Mlp('fused')`` against the flax modules
    of the JAX package, weights through ``state_dict_from_jax``."""
    from basd_tpu.models.layers import Attention as JAttention
    from basd_tpu.models.layers import Mlp as JMlp
    from basd_tpu.models.vit import ViTConfig as JViTConfig
    from basd_tpu.models.vit import VisionTransformer as JViT
    from basd_tpu_torch.models.layers import Attention, Mlp
    from basd_tpu_torch.models.port import state_dict_from_jax

    cfg = JViTConfig(img_size=32, patch_size=8, embed_dim=48, depth=1,
                     num_heads=3, num_classes=0)
    params = JViT(cfg).init(jax.random.PRNGKey(4), jnp.zeros((1, 32, 32, 3)))
    sd = state_dict_from_jax(params["params"])
    blocks = params["params"]["blocks"]
    x = _pair((4, 17, 48), "bfloat16")
    bf = torch.bfloat16

    attn = Attention(48, 3, mode, bf, attention_impl="flash")
    attn.load_state_dict({k[len("blocks.0.attn."):]: v for k, v in sd.items()
                          if k.startswith("blocks.0.attn.")})
    out, imp = attn(x[1])
    ref, ref_imp = JAttention(3, importance_mode=mode, dtype=jnp.bfloat16,
                              attention_impl="flash").apply(
        {"params": _block0(blocks["attn"])}, x[0])
    _close(out, ref, 2 ** -5, 1.0, "Attention('flash')")
    if mode is None:
        assert imp is None and ref_imp is None
    else:
        np.testing.assert_allclose(_np(imp), _np(ref_imp), rtol=0, atol=1e-6)

    mlp = Mlp(48, 192, bf, mlp_impl="fused")
    mlp.load_state_dict({k[len("blocks.0.mlp."):]: v for k, v in sd.items()
                         if k.startswith("blocks.0.mlp.")})
    ref = JMlp(192, 48, dtype=jnp.bfloat16, mlp_impl="fused").apply(
        {"params": _block0(blocks["mlp"])}, x[0])
    _close(mlp(x[1]), ref, 2 ** -5, 1.0, "Mlp('fused')")


def test_bf16_student_flash_fused_matches_jax():
    """A whole bf16 student on ``flash`` / ``fused`` (K10 and K11 per block,
    the plain versions here; depth 2, three heads: the head-loop kernel)
    against the JAX package's in interpret mode, same flax weights: logits,
    tokens and every parameter gradient of a fixed random linear loss."""
    from basd_tpu.models.vit import ViTConfig as JViTConfig
    from basd_tpu.models.vit import VisionTransformer as JViT
    from basd_tpu_torch.models.port import state_dict_from_jax
    from basd_tpu_torch.models.vit import ViTConfig, VisionTransformer

    cfg_kw = dict(img_size=32, patch_size=8, num_classes=10, embed_dim=48,
                  depth=2, num_heads=3, drop_path_rate=0.0)
    impls = dict(attention_impl="flash", mlp_impl="fused")
    xj = _pair((4, 32, 32, 3), "bfloat16")
    jm = JViT(JViTConfig(**cfg_kw), dtype=jnp.bfloat16, **impls)
    params = jm.init(jax.random.PRNGKey(3), xj[0])
    w_log = RNG.standard_normal((4, 10)).astype(np.float32)
    w_tok = RNG.standard_normal((2, 4, 16, 48)).astype(np.float32)

    def jloss(p):
        out = jm.apply(p, xj[0])
        loss = jnp.sum(out["logits"].astype(jnp.float32) * w_log)
        loss += jnp.sum(out["tokens"].astype(jnp.float32) * w_tok)
        return loss, out

    (_, ref), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)

    model = VisionTransformer(ViTConfig(**cfg_kw), dtype=torch.bfloat16,
                              **impls)
    model.load_state_dict(state_dict_from_jax(params["params"]))
    out = model(xj[1])
    loss = (out["logits"].float() * torch.from_numpy(w_log)).sum()
    loss = loss + (out["tokens"].float() * torch.from_numpy(w_tok)).sum()
    loss.backward()

    _close(out["logits"], ref["logits"], 2 ** -5, 1.0, "logits")
    _close(out["tokens"], ref["tokens"], 2 ** -5, 1.0, "tokens")
    ref_grads = state_dict_from_jax(jgrads["params"])
    named = dict(model.named_parameters())
    assert set(named) == set(ref_grads)
    for k, p in named.items():
        _close(p.grad, ref_grads[k], 2 ** -5, what=k)


def test_bf16_teacher_flash_matches_jax():
    """The frozen cls/collect teacher on ``flash`` (K10c per block, four
    heads: the head-pair kernel) against the JAX package's in interpret
    mode: collected tokens, CLS rows and importance."""
    from basd_tpu.models.vit import ViTConfig as JViTConfig
    from basd_tpu.models.vit import VisionTransformer as JViT
    from basd_tpu_torch.models.port import state_dict_from_jax
    from basd_tpu_torch.models.vit import ViTConfig, VisionTransformer

    cfg_kw = dict(img_size=32, patch_size=8, num_classes=0, embed_dim=64,
                  depth=2, num_heads=4)
    xj = _pair((4, 32, 32, 3), "bfloat16")
    jm = JViT(JViTConfig(**cfg_kw), importance_mode="cls", dtype=jnp.bfloat16,
              attention_impl="flash", collect_alias=True)
    params = jm.init(jax.random.PRNGKey(5), xj[0])
    ref = jm.apply(params, xj[0])
    model = VisionTransformer(ViTConfig(**cfg_kw), importance_mode="cls",
                              collect=True, dtype=torch.bfloat16,
                              attention_impl="flash")
    model.load_state_dict(state_dict_from_jax(params["params"]))
    with torch.no_grad():
        out = model(xj[1])
    _close(out["tokens"].to_dense(), ref["tokens"].to_dense(), 2 ** -5, 1.0,
           "tokens")
    _close(out["tokens"].cls, ref["tokens"].cls, 2 ** -5, 1.0, "cls rows")
    _close(out["logits"], ref["logits"], 2 ** -5, 1.0, "pooled")
    ia, ib = _np(out["importance"]), _np(ref["importance"])
    assert ia.shape == ib.shape
    assert np.abs(ia - ib).max() <= 2e-2 * ib.max()


def test_state_dict_from_jax_loads_flash_fused_params_unchanged():
    """The flash / fused impls declare exactly the einsum / dense
    parameters, so a flash/fused flax tree loads into a flash/fused port
    model strictly and equals the einsum/dense tree's mapping."""
    from basd_tpu.models.vit import ViTConfig as JViTConfig
    from basd_tpu.models.vit import VisionTransformer as JViT
    from basd_tpu_torch.models.port import state_dict_from_jax
    from basd_tpu_torch.models.vit import ViTConfig, VisionTransformer

    cfg_kw = dict(img_size=16, patch_size=8, num_classes=10, embed_dim=32,
                  depth=2, num_heads=2)
    x = jnp.zeros((1, 16, 16, 3), jnp.bfloat16)
    key = jax.random.PRNGKey(6)
    fused = JViT(JViTConfig(**cfg_kw), dtype=jnp.bfloat16,
                 attention_impl="flash", mlp_impl="fused").init(key, x)
    plain = JViT(JViTConfig(**cfg_kw), dtype=jnp.bfloat16,
                 attention_impl="einsum", mlp_impl="dense").init(key, x)
    sd, sd_plain = (state_dict_from_jax(p["params"]) for p in (fused, plain))
    assert set(sd) == set(sd_plain)
    for k in sd:
        assert torch.equal(sd[k], sd_plain[k]), k
    model = VisionTransformer(ViTConfig(**cfg_kw), dtype=torch.bfloat16,
                              attention_impl="flash", mlp_impl="fused")
    model.load_state_dict(sd, strict=True)
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k


@pytest.mark.parametrize("policy,error", [(None, None), ("full", None),
                                          ("dots", NotImplementedError),
                                          ("selective", ValueError)])
def test_remat_policy(policy, error):
    """``tpu.remat_policy``: null and ``full`` recompute whole blocks,
    ``dots`` is not ported, anything else is unknown (``vit.py:127-135``)."""
    from basd_tpu_torch.models.registry import create_model

    kw = dict(img_size=32, arch_overrides=dict(embed_dim=32, depth=1,
                                               num_heads=2, patch_size=8),
              remat=True, remat_policy=policy)
    if error is None:
        assert create_model("tiny", **kw).module.remat
    else:
        with pytest.raises(error, match="remat_policy"):
            create_model("tiny", **kw)
    # without remat the policy is not read, as in the JAX package
    assert not create_model("tiny", **dict(kw, remat=False)).module.remat


@pytest.fixture
def one_thread():
    """One intra-op thread: the CLI run is thousands of small ops, which
    thrash when the test workers share the cores with many threads each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.usefixtures("one_thread")
def test_cli_flash_fused_on_cpu(tmp_path):
    """``main`` with the three flash/fused overrides on the CPU (the plain
    versions of K10, K10c and K11): finite step losses; an unknown
    ``tpu.remat_policy`` raises."""
    from basd_tpu_torch.train import main

    args = ["experiment=smoke_synthetic", f"run.output_dir={tmp_path}",
            "data.batch_size=32", "+data.limit_train_batches=2",
            "+data.limit_eval_batches=1", "+eval.efficiency_batches=2",
            "tpu.teacher_attention_impl=flash",
            "tpu.student_attention_impl=flash", "tpu.student_mlp_impl=fused"]
    trainer = main(args, device="cpu")
    for blk in trainer.student.module.blocks:
        assert (blk.attention_impl, blk.mlp_impl) == ("flash", "fused")
    assert all(blk.attention_impl == "flash"
               for blk in trainer.teacher.module.blocks)
    lines = (tmp_path / "smoke_synthetic" / "metrics.jsonl").read_text()
    steps = [r for r in map(json.loads, lines.splitlines()) if r["kind"] == "step"]
    assert len(steps) == 2 and all(math.isfinite(r["loss"]) for r in steps)
    with pytest.raises(ValueError, match="remat_policy"):
        main(args + ["tpu.remat_policy=everything"], device="cpu")
