"""The frozen arithmetic against hand counts at small shapes."""

import dataclasses
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


def test_converged_eigh_rows_by_hand():
    from portbench.counts import launches_converged_eigh as k8c

    # SMALL, 'gram': the stacked (L + P, D_s) = (4, 4) batch and the
    # angles' (P L, r) = (4, 4); A read, V and w written: 4 (2 16 + 4) f32,
    # 4 9 4^3 operations at the f32 peak; bytes bind at this size
    one = 4 * 4 * (2 * 16 + 4) / counts.HBM_BYTES_S
    assert one > 4 * 9 * 64 / counts.PEAK_F32
    assert k8c.rows(SMALL) == {"K8 converged": [(one, 1), (one, 1)]}
    assert counts.kernel_launches(SMALL)["K8 converged"] == [(one, 1),
                                                             (one, 1)]
    # 'jacobi' takes its angles through K8: the stacked batch alone
    jacobi = dataclasses.replace(SMALL, backend="jacobi")
    assert k8c.rows(jacobi) == {"K8 converged": [(one, 1)]}
    # the route stops at n = 512: a wider student's stacked batch and
    # angles go to torch.linalg.eigh
    wide = dataclasses.replace(
        SMALL, student=dataclasses.replace(SMALL.student, dim=576),
        rank_cap=576)
    assert k8c.rows(wide) == {}
    assert k8c.rows(dataclasses.replace(SMALL, backend="svd")) == {}


@pytest.mark.parametrize("traffic", ["b256", "b512"])
def test_converged_eigh_at_the_dinov2_cells(traffic):
    # (16, 320, 320) and (48, 320, 320), bound by operations: 9 n^3 a
    # matrix over 67 TFLOP/s, 0.0704 and 0.211 ms
    with open(BENCH_DIR / "configs" / "dinov2_b14-s320_gram.json") as f:
        c = json.load(f)
    with open(BENCH_DIR / "traffic" / f"{traffic}.json") as f:
        t = json.load(f)
    rows = counts.kernel_launches(counts.step_shape(c, t))["K8 converged"]
    assert rows == [(16 * 9 * 320 ** 3 / counts.PEAK_F32, 1),
                    (48 * 9 * 320 ** 3 / counts.PEAK_F32, 1)]
    assert rows[0][0] * 1e3 == pytest.approx(0.0704, abs=1e-4)
    assert rows[1][0] * 1e3 == pytest.approx(0.2113, abs=1e-4)


def test_launch_modules_merge_their_rows(monkeypatch):
    class Module:
        @staticmethod
        def rows(shape):
            return {"K1 fused_block_attn": [(1.0, 2)], "K2g gated": [(2.0, 3)]}

    base = counts.kernel_launches(SMALL)
    monkeypatch.setattr(counts, "launch_modules", lambda: [Module])
    table = counts.kernel_launches(SMALL)
    assert table["K1 fused_block_attn"] == base["K1 fused_block_attn"] + [
        (1.0, 2)]
    assert table["K2g gated"] == [(2.0, 3)]
    assert "K8 converged" not in table
    # a SwiGLU teacher has no K2 row and a SwiGLU student no K4 rows
    gated = dataclasses.replace(
        SMALL, teacher=dataclasses.replace(SMALL.teacher, mlp="swiglu"),
        student=dataclasses.replace(SMALL.student, mlp="swiglu"))
    names = set(counts.kernel_launches(gated))
    assert not names & {"K2 fused_ln_mlp_collect", "K4a fused_ln_mlp fwd",
                        "K4b fused_ln_mlp bwd"}
    assert {"K2 fused_ln_mlp_collect", "K4a fused_ln_mlp fwd",
            "K4b fused_ln_mlp bwd"} <= set(base)


def test_kernel_names_files_skip_comments():
    from portbench.metrics.kernels_roofline import port_kernel_names

    names = port_kernel_names(BENCH_DIR)
    assert {"cluster_jacobi_kernel", "gemm_sm90_kernel"} <= names
    assert not {"The", "the", "K8", "converged", "#"} & names
