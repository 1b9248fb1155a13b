"""``remat_policy='dots'`` of the port's ViT (``basd_tpu_torch/models/vit.py``)
against the JAX package's (``basd_tpu/models/vit.py:126-136``), on the CPU
at bf16, depth 2, D=64, N=17, for the three student paths.

What a remat'd block keeps is counted per block on both sides:
``jax.ad_checkpoint.print_saved_residuals`` lists the JAX package's (the
per-block ones are the scan's outputs); on the port, the tensors that
``torch.autograd.graph.saved_tensors_hooks`` sees saved around one
checkpointed block (its input) plus the outputs the selective-checkpoint
policy keeps, which never pass through those hooks (the policy records
them). Tensors are compared by element count and dtype: the port's
products are 2-D (B*N, F) where the JAX package's are (B, N, F)."""

from __future__ import annotations

import contextlib
import io
import re
from collections import Counter

import numpy as np
import pytest
import torch
from torch.utils.checkpoint import CheckpointPolicy

import jax
import jax.numpy as jnp
from jax.ad_checkpoint import print_saved_residuals

from basd_tpu.models.vit import ViTConfig as JViTConfig
from basd_tpu.models.vit import VisionTransformer as JViT
from basd_tpu_torch.kernels import flash_attention as fa
from basd_tpu_torch.models import vit
from basd_tpu_torch.models.port import state_dict_from_jax

B, IMG, PATCH, D, DEPTH, HEADS, C = 2, 16, 4, 64, 2, 2, 10
N = (IMG // PATCH) ** 2 + 1
PATHS = (("fused_block_train", "fused_ln"), ("flash", "fused"),
         ("einsum", "dense"))
_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def _jax_model(attn, mlp, policy):
    cfg = JViTConfig(img_size=IMG, patch_size=PATCH, embed_dim=D, depth=DEPTH,
                     num_heads=HEADS, num_classes=C)
    return JViT(cfg, remat=True, remat_policy=policy, attention_impl=attn,
                mlp_impl=mlp, dtype=jnp.bfloat16)


def _jax_block_residuals(attn, mlp, policy) -> Counter:
    """(numel, dtype) of the residuals one block keeps: the scan's outputs,
    stacked over the depth."""
    model = _jax_model(attn, mlp, policy)
    x = jnp.ones((B, IMG, IMG, 3), jnp.bfloat16)
    params = model.init(jax.random.PRNGKey(0), x)["params"]

    def f(p):
        out = model.apply({"params": p}, x, deterministic=True)
        return (out["logits"].astype(jnp.float32).sum()
                + out["tokens"].astype(jnp.float32).sum())

    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        print_saved_residuals(f, params)
    found = Counter()
    for line in text.getvalue().splitlines():
        m = re.match(r"(\w+)\[([\d,]*)\] output of scan", line)
        if m:
            shape = [int(v) for v in m.group(2).split(",")]
            assert shape[0] == DEPTH, line
            found[(int(np.prod(shape[1:])), _DTYPES[m.group(1)])] += 1
    return found


def _port_model(attn, mlp, policy):
    torch.manual_seed(0)
    cfg = vit.ViTConfig(img_size=IMG, patch_size=PATCH, embed_dim=D,
                        depth=DEPTH, num_heads=HEADS, num_classes=C)
    return vit.VisionTransformer(cfg, remat=True, remat_policy=policy,
                                 attention_impl=attn, mlp_impl=mlp,
                                 dtype=torch.bfloat16)


def _port_block_kept(monkeypatch, attn, mlp, policy) -> Counter:
    """(numel, dtype) of what one checkpointed block of the port keeps: the
    activations its saved-tensor hooks see (no parameter) and the outputs
    the dots policy keeps."""
    kept = Counter()
    policy_fn = vit.dots_policy

    def recording(ctx, op, *args, **kwargs):
        decision = policy_fn(ctx, op, *args, **kwargs)
        if decision == CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
            out = ctx.op_output
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                kept[(t.numel(), t.dtype)] += 1
        return decision

    monkeypatch.setattr(vit, "dots_policy", recording)
    model = _port_model(attn, mlp, policy)
    params = {id(p) for p in model.parameters()}
    x = torch.randn((B, N, D)).to(torch.bfloat16).requires_grad_(True)

    def pack(t):
        if id(t) not in params:
            kept[(t.numel(), t.dtype)] += 1
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y, _ = vit.remat_block(model.blocks[0], x, None, policy)
    y.float().sum().backward()
    return kept


@pytest.mark.parametrize("attn,mlp", PATHS)
def test_dots_keeps_what_jax_keeps(monkeypatch, attn, mlp):
    """Per block, ``dots`` keeps the JAX package's residuals. The one
    difference, on the flash path, is K10a's logsumexp (B, H, N) f32: the
    port keeps it, the JAX package keeps o but not lse and so runs its flash
    forward again in the backward; the port's K10a runs once."""
    bnd = B * N * D
    expected = _jax_block_residuals(attn, mlp, "dots")
    extra = Counter({(B * HEADS * N, torch.float32): 1} if attn == "flash"
                    else {})
    assert _port_block_kept(monkeypatch, attn, mlp, "dots") == expected + extra
    # the table: the fused path keeps only the block input; the flash path
    # adds qkv, attn_out and proj; the chain qkv, scores, P.V, proj, fc1
    bf = torch.bfloat16
    table = {
        "fused_block_train": {(bnd, bf): 1},
        "flash": {(bnd, bf): 3, (3 * bnd, bf): 1},
        "einsum": {(bnd, bf): 3, (3 * bnd, bf): 1, (4 * bnd, bf): 1,
                   (B * HEADS * N * N, bf): 1},
    }[attn]
    assert expected == Counter(table)
    full = _jax_block_residuals(attn, mlp, "full")
    assert full == Counter({(bnd, bf): 1})
    assert _port_block_kept(monkeypatch, attn, mlp, "full") == full


@pytest.mark.parametrize("attn,mlp", PATHS)
def test_dots_gradients_equal_full(monkeypatch, attn, mlp):
    """Loss and every parameter gradient under ``dots`` equal ``full``'s bit
    for bit; on the flash path K10a's forward (its plain version here) runs
    once per block where ``full`` runs it twice. The JAX package's student
    weights, so both packages' paths are the same function."""
    calls = []
    plain = fa.flash_attention_plain_fwd
    monkeypatch.setattr(fa, "flash_attention_plain_fwd",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    jparams = _jax_model(attn, mlp, "full").init(
        jax.random.PRNGKey(3), jnp.ones((B, IMG, IMG, 3), jnp.bfloat16))
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (B, IMG, IMG, 3)).astype(np.float32)).to(torch.bfloat16)
    runs = {}
    for policy in ("full", "dots"):
        model = _port_model(attn, mlp, policy)
        model.load_state_dict(state_dict_from_jax(jparams["params"]))
        calls.clear()
        out = model(x, deterministic=True)
        loss = out["logits"].float().sum() + out["tokens"].float().sum()
        grads = torch.autograd.grad(loss, list(model.parameters()))
        runs[policy] = (loss, grads, len(calls))
    (l_full, g_full, n_full), (l_dots, g_dots, n_dots) = runs.values()
    assert torch.equal(l_full, l_dots)
    for a, b in zip(g_full, g_dots):
        assert torch.equal(a, b)
    if attn == "flash":
        assert (n_full, n_dots) == (2 * DEPTH, DEPTH)


def test_remat_policy_refuses_unknown():
    with pytest.raises(ValueError, match="unknown remat_policy"):
        _port_model("einsum", "dense", "offload")
