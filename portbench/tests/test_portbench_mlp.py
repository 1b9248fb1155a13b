"""A configuration states its ViTs' MLP kind as data: GELU (the default)
or SwiGLU (``"mlp": "swiglu"`` with ``"mlp_hidden"``), in the weights the
benchmark draws, the reference and the yardstick. A SwiGLU teacher runs
through the inputs and the reference from a configuration dict alone, and
the GELU configurations draw and compute what they did before."""

import hashlib
import math

import pytest
import torch
import torch.nn.functional as F

from portbench import bench, counts
from portbench.inputs import make_inputs, make_vit_weights, vit_leaves
from portbench.reference import model
from portbench.reference.arith import Arith
from portbench.reference.step import reference_steps
from portbench.tests.tiny import tiny_cell

SWIGLU = {"mlp": "swiglu", "mlp_hidden": 96}
# ViT-g/14 (DINOv2's dinov2_vitg14; timm's vit_giant_patch14_dinov2)
VIT_G = {"embed_dim": 1536, "depth": 40, "num_heads": 24, "mlp_ratio": 4.0,
         "patch_size": 14, "layerscale": True, "mlp": "swiglu",
         "mlp_hidden": 4096}
# make_inputs and the reference's three losses at the tiny cell, seed
# 2**33 + 17, before the MLP kind existed
GOLDEN = {
    "dinov2_b14-s320_gram": (
        "29baf6b1c7e889c09a0274670b9a43fafd373c78f0e5a9466084274dca6166b4",
        [6.048519611358643, 4.972917556762695, 5.22986364364624]),
    "deit_s-ti_jacobi": (
        "56aa2deb0b3c6aa81a3ca334a58b7f6dbac61d3a4b9d5b61c02cf5e80ecf7b3c",
        [6.245398044586182, 6.008930206298828, 6.314787864685059]),
}


def digest(inp: dict) -> str:
    h = hashlib.sha256()
    for part in ("teacher", "student", "selector"):
        for k, v in inp[part].items():
            h.update(k.encode())
            h.update(v.detach().cpu().contiguous().numpy().tobytes())
    h.update(inp["log_temperatures"].cpu().numpy().tobytes())
    for t in inp["images"] + inp["labels"]:
        h.update(t.cpu().contiguous().numpy().tobytes())
    h.update(str(inp["run_seed"]).encode())
    return h.hexdigest()


@pytest.mark.parametrize("config", sorted(GOLDEN))
def test_gelu_configurations_draw_and_compute_as_before(config):
    torch.set_num_threads(2)
    cell = tiny_cell(config)
    seed = 2 ** 33 + 17
    want_digest, want_losses = GOLDEN[config]
    assert digest(make_inputs(cell.config, cell.traffic, seed, "cpu")) == (
        want_digest)
    ref = reference_steps(cell.config, cell.traffic, seed, "cpu")
    assert ref["losses"] == pytest.approx(want_losses, rel=1e-6)


def test_mlp_of():
    gelu = {"embed_dim": 192, "mlp_ratio": 4.0}
    assert counts.mlp_of(gelu) == ("gelu", 768)
    assert counts.mlp_of(VIT_G) == ("swiglu", 4096)
    with pytest.raises(ValueError, match="mlp_hidden"):
        counts.mlp_of({**gelu, "mlp": "swiglu"})
    with pytest.raises(ValueError, match="unknown MLP kind"):
        counts.mlp_of({**gelu, "mlp": "relu"})


def test_swiglu_leaves():
    m = {"embed_dim": 8, "depth": 2, "num_heads": 2, "mlp_ratio": 4.0,
         "patch_size": 4, "layerscale": True}
    gelu = dict(vit_leaves(m, 16, 3))
    swiglu = dict(vit_leaves({**m, "mlp": "swiglu", "mlp_hidden": 12}, 16, 3))
    # the same names in the same order; fc1 packed [a | g] at (2 F, D)
    assert list(gelu) == list(swiglu)
    for i in range(2):
        b = f"blocks.{i}.mlp."
        assert gelu[b + "fc1.weight"] == (32, 8)
        assert swiglu[b + "fc1.weight"] == (24, 8)
        assert swiglu[b + "fc1.bias"] == (24,)
        assert swiglu[b + "fc2.weight"] == (8, 12)
        assert swiglu[b + "fc2.bias"] == (8,)
    assert {k: v for k, v in gelu.items() if ".mlp." not in k} == {
        k: v for k, v in swiglu.items() if ".mlp." not in k}


def test_vit_g14_parameter_count():
    d, f, L = 1536, 4096, 40
    embed = d + 257 * d + d * 3 * 14 * 14 + d
    per_block = (4 * d + 3 * d * d + 3 * d + d * d + d + 2 * d
                 + 2 * f * d + 2 * f + d * f + d)
    total = sum(math.prod(s) for _, s in vit_leaves(VIT_G, 224, 0))
    assert total == embed + L * per_block + 2 * d == 1_134_769_664


def dinov2_block(x, w: dict, heads: int, eps: float):
    """DINOv2's block with its SwiGLUFFN: ``w12`` (fc1) chunked in two,
    silu on the first half, ``w3`` (fc2)."""
    b, n, d = x.shape
    h = F.layer_norm(x, (d,), w["norm1.weight"], w["norm1.bias"], eps)
    qkv = F.linear(h, w["attn.qkv.weight"], w["attn.qkv.bias"])
    q, k, v = qkv.reshape(b, n, 3, heads, d // heads).permute(2, 0, 3, 1, 4)
    a = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(
        b, n, d)
    x = x + w["ls1.gamma"] * F.linear(a, w["attn.proj.weight"],
                                      w["attn.proj.bias"])
    h = F.layer_norm(x, (d,), w["norm2.weight"], w["norm2.bias"], eps)
    x1, x2 = F.linear(h, w["mlp.fc1.weight"], w["mlp.fc1.bias"]).chunk(2, -1)
    y = F.linear(F.silu(x1) * x2, w["mlp.fc2.weight"], w["mlp.fc2.bias"])
    return x + w["ls2.gamma"] * y


def test_swiglu_block_against_dinov2():
    m = {"embed_dim": 16, "depth": 1, "num_heads": 2, "mlp_ratio": 4.0,
         "patch_size": 4, "layerscale": True, "mlp": "swiglu",
         "mlp_hidden": 24}
    law = {"gain": 1.0, "bias_std": 0.02, "norm_weight_std": 0.1,
           "norm_bias_std": 0.02, "cls_std": 0.02, "pos_std": 0.02,
           "layerscale": 0.5, "layerscale_spread": 0.1}
    wts = make_vit_weights(m, 8, 0, law, 5, "cpu")
    x = torch.randn(3, 5, 16, generator=torch.Generator().manual_seed(6))
    got, _ = model.block(Arith("f32"), x, wts, 0, 2, 1e-6, "none",
                         kind="swiglu")
    want = dinov2_block(x, {k[len("blocks.0."):]: v for k, v in wts.items()
                            if k.startswith("blocks.0.")}, 2, 1e-6)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    # the GELU block on the same weights cannot take fc1's packed halves
    with pytest.raises(RuntimeError):
        model.block(Arith("f32"), x, wts, 0, 2, 1e-6, "none")


def test_swiglu_teacher_from_a_configuration_dict():
    torch.set_num_threads(2)
    cell = tiny_cell(teacher=SWIGLU)
    seed = 2 ** 33 + 19
    inp = make_inputs(cell.config, cell.traffic, seed, "cpu")
    assert inp["teacher"]["blocks.2.mlp.fc1.weight"].shape == (192, 64)
    assert inp["teacher"]["blocks.2.mlp.fc2.weight"].shape == (64, 96)
    ref = reference_steps(cell.config, cell.traffic, seed, "cpu")
    assert len(ref["losses"]) == 3
    assert all(math.isfinite(v) for v in ref["losses"])
    gelu = reference_steps(tiny_cell().config, cell.traffic, seed, "cpu",
                           steps=1)
    assert gelu["losses"][0] != ref["losses"][0]
    # the yardstick takes the same dict
    shape = counts.step_shape(cell.config, cell.traffic)
    assert (shape.teacher.mlp, shape.teacher.hidden) == ("swiglu", 96)
    assert shape.student.mlp == "gelu"
    table = counts.kernel_launches(shape)
    assert "K2 fused_ln_mlp_collect" not in table
    assert "K4a fused_ln_mlp fwd" in table
    # the port is handed the kind and width the configuration states
    assert {k: bench.arch(cell.config["teacher"])[k]
            for k in ("mlp", "mlp_hidden")} == SWIGLU
    assert not {"mlp", "mlp_hidden"} & set(bench.arch(
        tiny_cell().config["teacher"]))


def test_swiglu_block_flops_by_hand():
    # m = 10 rows, b = 2 images of n = 5 tokens, d = 4, f = 16: fc1 makes
    # 2 F of each row, fc2 takes F
    assert counts.vit_block_flops(10, 2, 5, 4, 16, "swiglu") == (
        2 * 10 * (4 * 16 + 3 * 4 * 16) + 4 * 2 * 25 * 4)
    v = counts.ViTShape(8, 2, 2, 32, 16, 32, "swiglu")
    embed = 2 * 3 * 4 * (3 * 256) * 8
    blocks = 2 * counts.vit_block_flops(3 * 5, 3, 5, 8, 32, "swiglu")
    assert counts.vit_forward_flops(v, 3) == embed + blocks
