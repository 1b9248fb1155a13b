"""The frozen arithmetic against hand counts at small shapes."""

import json

import pytest

from portbench import counts
from portbench.cells import BENCH_DIR

SMALL = counts.StepShape(
    batch=2, teacher=counts.ViTShape(8, 2, 2, 32, 16, 32),
    student=counts.ViTShape(4, 3, 1, 16, 16, 32), classes=5, points=2,
    rank_cap=4, backend="gram")


def test_polar_flops_by_hand():
    # r = 2, c = 3, one matrix: per quintic step X X^T 2*3*3 = 18,
    # G G^T 2*3*2 = 12, H X 2*2*2*3 = 24; per cubic step 18 + 24
    assert counts.polar_flops(1, 2, 3) == 5 * (18 + 12 + 24) + 2 * (18 + 24)
    assert counts.polar_flops(7, 2, 3) == 7 * counts.polar_flops(1, 2, 3)


def test_block_and_vit_flops_by_hand():
    # m = 10 rows, b = 2 images of n = 5 tokens, d = 4, f = 16
    assert counts.vit_block_flops(10, 2, 5, 4, 16) == (
        2 * 10 * (4 * 16 + 2 * 4 * 16) + 4 * 2 * 25 * 4)
    v = counts.ViTShape(8, 2, 2, 32, 16, 32)  # 4 patches, 5 tokens
    embed = 2 * 3 * 4 * (3 * 256) * 8
    blocks = 2 * counts.vit_block_flops(3 * 5, 3, 5, 8, 32)
    assert counts.vit_forward_flops(v, 3, classes=7) == embed + blocks + 2 * 3 * 8 * 7


def test_step_model_flops_by_hand():
    f = counts.step_model_flops(SMALL)
    s = SMALL.student
    embed_s = 2 * 2 * 4 * 768 * 4
    assert f["student"] == 3 * counts.vit_forward_flops(s, 2, 5) - embed_s
    assert f["teacher"] == counts.vit_forward_flops(SMALL.teacher, 2)
    L, P, r, ds, dt = 2, 2, 4, 4, 8
    m_t, m_s, m_flat = 2 * 4, 2 * 4, 2 * 5
    grams = (2 * L * m_t * dt * dt + L * 2 * (ds * dt * dt + ds * ds * dt)
             + 3 * P * (2 * m_s * ds * ds + 4 * ds ** 3))
    eigh = (L + P) * 9 * ds ** 3 + P * L * 9 * r ** 3
    angles = 3 * P * L * (2 * ds * r * r + 2 * r ** 3)
    mix = 4 * P * L * m_flat * dt
    procrustes = 6 * P * 2 * 4 * ds * dt
    polar = counts.polar_flops(P * 2, ds, dt)
    assert f["loss"] == pytest.approx(
        grams + eigh + angles + mix + procrustes + polar, rel=1e-12)
    assert counts.total_model_flops(SMALL) == pytest.approx(sum(f.values()))


def test_kernel_bounds_by_hand():
    table = counts.kernel_launches(SMALL)
    # K6a: weights (P, L) bf16, the (L, B*N, D) stack in, (P, B*N, D) out;
    # 2 P B N D L operations, bytes bind at this size
    moved = 2 * 2 * 2 + 2 * 2 * 10 * 8 + 2 * 2 * 10 * 8
    assert table["K6a mix_stack fwd"] == [(moved / counts.HBM_BYTES_S, 1)]
    # K5a at the student's (B N, D) = (10, 4): bf16 in and out, f32 scale
    # and bias, f32 mean and rstd a row
    assert table["K5a fused_layernorm fwd"][1] == (
        (2 * 2 * 10 * 4 + 4 * 2 * 4 + 4 * 2 * 10) / counts.HBM_BYTES_S, 1)
    # the student's blocks under remat: K3a and K4a twice a block
    assert table["K3a fused_block_attn_train fwd"][0][1] == 6
    assert table["K4b fused_ln_mlp bwd"][0][1] == 3
    assert "K8 jacobi_eigh" not in table


def test_bound_follows_the_counters():
    table = counts.kernel_launches(SMALL)
    one = sum(sec * n for sec, n in table["K1 fused_block_attn"])
    total, unknown = counts.kernel_bound_seconds(
        SMALL, {"K1 fused_block_attn": 4, "K99 new": 1, "K7 ns_polar_hybrid": 0})
    assert total == pytest.approx(one * 4 / 2)
    assert unknown == ["K99 new"]


@pytest.mark.parametrize("cfg,traffic,tflop", [
    ("dinov2_b14-s320_gram", "b256", 20.33),
    ("deit_s-ti_jacobi", "b1024", 19.69),
    ("dinov2_b14-s320_gram", "b512", 40.61)])
def test_cells_model_flops(cfg, traffic, tflop):
    with open(BENCH_DIR / "configs" / f"{cfg}.json") as f:
        c = json.load(f)
    with open(BENCH_DIR / "traffic" / f"{traffic}.json") as f:
        t = json.load(f)
    s = counts.step_shape(c, t)
    assert counts.total_model_flops(s) / 1e12 == pytest.approx(tflop, abs=0.01)
    assert s.rank_cap == (96 if cfg.startswith("deit") else 320)
