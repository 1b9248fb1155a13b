"""The student path's kernels of the port (K3 attention half, K4 MLP half,
K5 LayerNorm, K9 TAW shifts) against the JAX package's Pallas kernels in
interpret mode, on the same numpy inputs; and a whole bf16 student with the
fused impls in both packages.

On CPU tensors the port's wrappers run their plain versions, so these tests
hold the plain versions (and the autograd functions around them) to the
reference; chip_smoke.py holds the CUDA/Triton kernels to the plain
versions on the card.

Tolerances: bf16 outputs and dx within 2^-5 * max(|ref|, 1) (one bf16
rounding of the largest value, as for K1/K2); f32 weight, bias and LN
gradients of the kernels' own outputs within 1e-3 of the leaf's max |ref|.
Through ``jax.vjp`` / ``torch.autograd`` the weight gradients come back
cast to the bf16 weights' dtype (as the JAX package's VJPs return them):
there two f32 values that differ by 1e-5 may round one bf16 ulp apart, and
an ulp is up to 2^-7 of the value, so those are held to 2^-7 of the leaf
max.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from basd_tpu_torch.kernels import block_attn, block_mlp, geom_shift, layernorm

RNG = np.random.default_rng(11)
EPS = 1e-6
BF16_ULP = 2 ** -7


def _bf16_pair(shape, scale=1.0):
    """The same bf16 values as a jax array and a torch tensor."""
    a = (RNG.standard_normal(shape) * scale).astype(np.float32)
    j = jnp.asarray(a).astype(jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)


def _f32_pair(shape, scale=1.0, offset=0.0):
    a = (RNG.standard_normal(shape) * scale + offset).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _mask_pair(b, keep=0.75):
    """Stochastic-depth multipliers: zeros and 1/keep."""
    m = np.where(np.arange(b) % 2 == 0, np.float32(1.0) / np.float32(keep),
                 np.float32(0.0)).astype(np.float32)
    return jnp.asarray(m), torch.from_numpy(m)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.array(jnp.asarray(t).astype(jnp.float32))


def _t(pair):
    """torch side of a pair, transposed to (out, in) for 2-D weights."""
    return pair[1].t().contiguous() if pair[1].dim() == 2 else pair[1]


def _close(a, r, rel, floor=0.0, what=""):
    a, r = _np(a), _np(r)
    assert a.shape == r.shape, what
    err = np.abs(a - r).max()
    scale = max(np.abs(r).max(), floor)
    assert err <= rel * scale, f"{what}: {err} > {rel} * {scale}"


def _weights(d, f):
    ln_s = _f32_pair((d,), 0.1, 1.0)
    ln_b = _f32_pair((d,), 0.1)
    wq = _bf16_pair((d, 3 * d), d ** -0.5)  # JAX (in, out) layout
    bq = _f32_pair((3 * d,), 0.1)
    wp = _bf16_pair((d, d), d ** -0.5)
    bp = _f32_pair((d,), 0.1)
    w1 = _bf16_pair((d, f), d ** -0.5)
    b1 = _f32_pair((f,), 0.1)
    w2 = _bf16_pair((f, d), f ** -0.5)
    b2 = _f32_pair((d,), 0.1)
    return ln_s, ln_b, wq, bq, wp, bp, w1, b1, w2, b2


def _leaves(*pairs, mask_index=1):
    """torch leaves (weights in (out, in) layout) that record gradients,
    the mask excepted."""
    out = []
    for i, p in enumerate(pairs):
        t = _t(p).clone()
        if i != mask_index:
            t.requires_grad_(True)
        out.append(t)
    return out


def _check_vjp(jax_grads, torch_leaves, transposed, what):
    """Gradients through the differentiable functions: dx at bf16
    tolerance; bf16 weight grads within an ulp of the leaf max; f32 LN and
    bias grads within 1e-3 of the leaf max."""
    for i, (jg, leaf) in enumerate(zip(jax_grads, torch_leaves)):
        if i == 1:  # the mask is not differentiated
            assert leaf.grad is None
            continue
        g = leaf.grad.t() if i in transposed else leaf.grad
        if i == 0:
            _close(g, jg, 2 ** -5, 1.0, f"{what} dx")
        elif leaf.dtype == torch.bfloat16:
            _close(g, jg, BF16_ULP, what=f"{what} grad {i}")
        else:
            _close(g, jg, 1e-3, what=f"{what} grad {i}")


@pytest.mark.parametrize("heads", [2, 4])
def test_k3_matches_jax_fused_block_attn_train(heads):
    from basd_tpu.ops.pallas import fused_block_attn as jfba

    b, n, d = 4, 17, 64
    x = _bf16_pair((b, n, d))
    mask = _mask_pair(b)
    ln_s, ln_b, wq, bq, wp, bp, *_ = _weights(d, 4 * d)
    cot = _bf16_pair((b, n, d))
    pairs = (x, mask, ln_s, ln_b, wq, bq, wp, bp)

    # the kernels: forward (out, lse) and the backward's f32 gradients
    j_out, j_lse = jfba._fwd_train(*(p[0] for p in pairs), heads, EPS, True)
    t_args = [_t(p) for p in pairs]
    out, lse = block_attn.fused_block_attn_train_fwd(*t_args, heads, EPS)
    _close(out, j_out, 2 ** -5, 1.0, "K3a out")
    _close(lse, j_lse, 1e-5, 1.0, "K3a lse")
    j_grads = jfba._bwd_train(x[0], mask[0], cot[0], j_lse, ln_s[0], ln_b[0],
                              wq[0], bq[0], wp[0], heads, EPS, True)
    grads = block_attn.fused_block_attn_train_bwd(
        x[1], mask[1], cot[1], lse, ln_s[1], ln_b[1], _t(wq), bq[1], _t(wp),
        heads, EPS)
    _close(grads[0], j_grads[0], 2 ** -5, 1.0, "K3b dx")
    for i, (g, jg) in enumerate(zip(grads[1:], j_grads[1:]), 1):
        jg = np.asarray(jg)
        jg = jg.T if i in (1, 3) else jg.reshape(-1)  # (in, out) -> (out, in)
        _close(g, jg, 1e-3, what=f"K3b grad {i}")

    # the differentiable function, through jax.vjp and torch.autograd
    ref, vjp = jax.vjp(
        lambda *a: jfba.fused_block_attn_train(*a, heads, EPS, True),
        *(p[0] for p in pairs))
    leaves = _leaves(*pairs)
    out = block_attn.fused_block_attn_train(*leaves, heads, EPS)
    _close(out, ref, 2 ** -5, 1.0, "K3 out")
    out.backward(cot[1])
    _check_vjp(vjp(cot[0]), leaves, (4, 6), "K3")


def test_k4_matches_jax_fused_ln_mlp():
    from basd_tpu.ops.pallas import fused_block_mlp as jfbm

    b, n, d, f = 4, 17, 64, 256
    x = _bf16_pair((b, n, d))
    mask = _mask_pair(b)
    ln_s, ln_b, *_, w1, b1, w2, b2 = _weights(d, f)
    cot = _bf16_pair((b, n, d))
    pairs = (x, mask, ln_s, ln_b, w1, b1, w2, b2)

    j_out = jfbm._fwd(*(p[0] for p in pairs), EPS, True)
    out = block_mlp.fused_ln_mlp_fwd(*(_t(p) for p in pairs), EPS)
    _close(out, j_out, 2 ** -5, 1.0, "K4a out")
    j_grads = jfbm._bwd(x[0], mask[0], cot[0], ln_s[0], ln_b[0], w1[0], b1[0],
                        w2[0], EPS, True)
    grads = block_mlp.fused_ln_mlp_bwd(x[1], mask[1], cot[1], ln_s[1],
                                       ln_b[1], _t(w1), b1[1], _t(w2), EPS)
    _close(grads[0], j_grads[0], 2 ** -5, 1.0, "K4b dx")
    for i, (g, jg) in enumerate(zip(grads[1:], j_grads[1:]), 1):
        jg = np.asarray(jg)
        jg = jg.T if i in (1, 3) else jg.reshape(-1)
        _close(g, jg, 1e-3, what=f"K4b grad {i}")

    ref, vjp = jax.vjp(lambda *a: jfbm.fused_ln_mlp(*a, EPS, True),
                       *(p[0] for p in pairs))
    leaves = _leaves(*pairs)
    out = block_mlp.fused_ln_mlp(*leaves, EPS)
    _close(out, ref, 2 ** -5, 1.0, "K4 out")
    out.backward(cot[1])
    _check_vjp(vjp(cot[0]), leaves, (4, 6), "K4")


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_k5_matches_jax_fused_layernorm(dtype):
    from basd_tpu.ops.pallas import layernorm as jln

    b, n, d = 4, 17, 64
    x = _bf16_pair((b, n, d), 2.0) if dtype == "bfloat16" else _f32_pair(
        (b, n, d), 2.0, 0.5)
    scale = _f32_pair((d,), 0.2, 1.0)
    bias = _f32_pair((d,), 0.2)
    cot = _bf16_pair((b, n, d)) if dtype == "bfloat16" else _f32_pair((b, n, d))
    rel = 2 ** -5 if dtype == "bfloat16" else 1e-5

    j_out, j_mu, j_rstd = jln._fwd(x[0], scale[0], bias[0], EPS, True)
    out, mu, rstd = layernorm.layernorm_fwd(x[1], scale[1], bias[1], EPS)
    _close(out, j_out, rel, 1.0, "K5a out")
    _close(mu, j_mu, 1e-5, 1.0, "K5a mu")
    _close(rstd, j_rstd, 1e-5, 1.0, "K5a rstd")
    j_dx, j_dw, j_db = jln._bwd(x[0], scale[0], j_mu, j_rstd, cot[0], True)
    dx, dw, db = layernorm.layernorm_bwd(x[1], scale[1], mu, rstd, cot[1])
    _close(dx, j_dx, rel, 1.0, "K5b dx")
    _close(dw, j_dw, 1e-3, what="K5b dscale")
    _close(db, j_db, 1e-3, what="K5b dbias")

    ref, vjp = jax.vjp(lambda *a: jln.fused_layernorm(*a, EPS, True),
                       x[0], scale[0], bias[0])
    leaves = [x[1].clone().requires_grad_(True),
              scale[1].clone().requires_grad_(True),
              bias[1].clone().requires_grad_(True)]
    out = layernorm.fused_layernorm(*leaves, EPS)
    _close(out, ref, rel, 1.0, "K5 out")
    out.backward(cot[1])
    j_dx, j_dw, j_db = vjp(cot[0])
    _close(leaves[0].grad, j_dx, rel, 1.0, "K5 dx")
    _close(leaves[1].grad, j_dw, 1e-3, what="K5 dscale")
    _close(leaves[2].grad, j_db, 1e-3, what="K5 dbias")


@pytest.mark.parametrize("m", [1, 15, 16, 17, 263, 264 * 16 - 1, 264 * 16,
                               264 * 16 + 1, 25216, 100003])
@pytest.mark.parametrize("rows", [8, 16, 32])
def test_k5b_row_partition(m, rows):
    """K5b's fixed grid: the programs' contiguous row ranges, walked in
    blocks of ``rows``, cover rows 0..m-1 exactly once and in order, for
    ragged M; the partial layout does not depend on the card."""
    programs = layernorm._BWD_PROGRAMS
    per, blocks = layernorm.ln_bwd_partition(m, programs, rows)
    assert per == blocks * rows and programs * per >= m
    assert programs * (per - rows) < m or per == rows  # no spare block
    covered = []
    for p in range(programs):
        start, end = p * per, min(m, (p + 1) * per)
        for i in range(blocks):
            covered.extend(r for r in range(start + i * rows,
                                            start + (i + 1) * rows) if r < end)
    assert covered == list(range(m))


# (op id, big rotation): every geometric TAW op, rotation on both sides of
# the 180-degree pre-flip
@pytest.mark.parametrize("op,big", [(1, False), (2, False), (3, False),
                                    (4, False), (5, False), (5, True)])
def test_k9_bit_exact_against_jax_geom_shift3(op, big):
    from basd_tpu.data import augment as jaug
    from basd_tpu.ops.pallas.geom_shift import geom_shift3 as jgeom
    from basd_tpu_torch.data import augment as aug

    g, h, w = 16, 24, 24
    x = RNG.integers(0, 256, (g, h, w, 3), dtype=np.uint8)
    hi = {1: 0.99, 2: 0.99, 3: 32.0, 4: 32.0, 5: 135.0}[op]
    lo = 90.5 if big else 0.0
    mag_np = (RNG.uniform(lo, hi if (big or op != 5) else 90.0, g)
              * RNG.choice([-1.0, 1.0], g)).astype(np.float32)
    op_t = torch.full((g,), op, dtype=torch.long)
    mag = torch.from_numpy(mag_np)
    flags, r1, r2, r3 = aug.geom_shifts(op_t, mag, h, w)
    assert bool(flags.all()) == big and bool(flags.any()) == big
    xt = torch.from_numpy(x)
    flipped = torch.where(flags[:, None, None, None], xt.flip(1, 2), xt)

    ours = geom_shift.geom_shift3(flipped, r1, r2, r3)
    theirs = jgeom(jnp.asarray(flipped.numpy()),
                   *(jnp.asarray(r.numpy(), jnp.int32) for r in (r1, r2, r3)),
                   interpret=True)
    assert torch.equal(ours, torch.from_numpy(np.array(theirs)))
    # and the whole geometric op against the JAX package's
    ref = jaug._geom_three_pass(jnp.asarray(x), jnp.full((g,), op),
                                jnp.asarray(mag_np))
    assert torch.equal(aug.geom_three_pass(xt, op_t, mag),
                       torch.from_numpy(np.array(ref)))


def test_bf16_student_fused_impls_match_jax():
    """A whole bf16 student on the fused impls (K3 and K4 per block, the
    plain versions here) against the JAX package's in interpret mode, same
    flax weights: logits, collected tokens and every parameter gradient of
    a fixed random linear loss. Gradients pass back through two blocks of
    bf16 arithmetic in two frameworks whose roundings differ by an ulp in
    places, so they are held to 2^-5 of each leaf's max."""
    from basd_tpu.models.vit import ViTConfig as JViTConfig
    from basd_tpu.models.vit import VisionTransformer as JViT
    from basd_tpu_torch.models.port import state_dict_from_jax
    from basd_tpu_torch.models.vit import ViTConfig, VisionTransformer

    cfg_kw = dict(img_size=32, patch_size=8, num_classes=10, embed_dim=64,
                  depth=2, num_heads=2, drop_path_rate=0.0)
    impls = dict(attention_impl="fused_block_train", mlp_impl="fused_ln")
    xj = jnp.asarray(RNG.standard_normal((4, 32, 32, 3)).astype(np.float32)
                     ).astype(jnp.bfloat16)
    jm = JViT(JViTConfig(**cfg_kw), dtype=jnp.bfloat16, **impls)
    params = jm.init(jax.random.PRNGKey(3), xj)
    w_log = RNG.standard_normal((4, 10)).astype(np.float32)
    w_tok = RNG.standard_normal((2, 4, 16, 64)).astype(np.float32)

    def jloss(p):
        out = jm.apply(p, xj)
        loss = jnp.sum(out["logits"].astype(jnp.float32) * w_log)
        loss += jnp.sum(out["tokens"].astype(jnp.float32) * w_tok)
        return loss, out

    (_, ref), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)

    model = VisionTransformer(ViTConfig(**cfg_kw), dtype=torch.bfloat16, **impls)
    model.load_state_dict(state_dict_from_jax(params["params"]))
    out = model(torch.from_numpy(np.array(xj.astype(jnp.float32))).to(torch.bfloat16))
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


def test_block_dispatch_on_cpu_and_unported_impls():
    """Off CUDA ``auto`` takes the module chain, as the JAX package does
    off the TPU, while an explicit fused impl takes the kernels' plain
    versions; ``flash`` / ``fused`` (K10/K11) build and run the module chain
    with K10's and K11's plain versions, which differ from the einsum chain
    (it rounds the scores to bf16) and from the fused blocks, and count no
    launch on the CPU."""
    from basd_tpu_torch import kernels
    from basd_tpu_torch.models.vit import ViTConfig, VisionTransformer

    cfg = ViTConfig(img_size=16, patch_size=8, embed_dim=32, depth=1,
                    num_heads=2, num_classes=3)
    models = {impl: VisionTransformer(cfg, dtype=torch.bfloat16,
                                      attention_impl=a, mlp_impl=m)
              for impl, (a, m) in {"auto": ("auto", "auto"),
                                   "module": ("module", "module"),
                                   "fused": ("fused_block_train", "fused_ln"),
                                   "flash": ("flash", "fused"),
                                   }.items()}
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in models["auto"].parameters():
            p.normal_(0.0, 0.3, generator=g)
    for m in models.values():
        m.load_state_dict(models["auto"].state_dict())
    x = torch.from_numpy(RNG.standard_normal((2, 16, 16, 3)).astype(np.float32)
                         ).to(torch.bfloat16)
    kernels.reset_launch_counts()
    logits = {k: m(x)["logits"] for k, m in models.items()}
    assert set(kernels.launch_counts().values()) == {0}
    assert torch.equal(logits["auto"], logits["module"])
    assert not torch.equal(logits["fused"], logits["module"])
    assert not torch.equal(logits["flash"], logits["module"])
    assert not torch.equal(logits["flash"], logits["fused"])
    # the flash/fused chain is K10's and K11's plain versions, block by block
    from basd_tpu_torch.kernels.flash_attention import flash_attention_plain_fwd
    from basd_tpu_torch.kernels.fused_mlp import fused_mlp_plain_fwd

    blk = models["flash"].blocks[0]
    xt = torch.from_numpy(RNG.standard_normal((2, 5, 32)).astype(np.float32)
                          ).to(torch.bfloat16)
    with torch.no_grad():
        y, _ = blk(xt)
        xn = blk.norm1(xt)
        o = flash_attention_plain_fwd(blk.attn.qkv(xn), 2, 16 ** -0.5)[0]
        h = xt + blk.attn.proj(o)
        mlp = blk.mlp
        ref = h + fused_mlp_plain_fwd(
            blk.norm2(h), mlp.fc1.weight.to(torch.bfloat16), mlp.fc1.bias,
            mlp.fc2.weight.to(torch.bfloat16), mlp.fc2.bias)
    assert torch.equal(y, ref)
