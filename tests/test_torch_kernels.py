"""Plain versions of the port's kernels against the JAX package's Pallas
kernels (interpret mode) on the same numpy inputs, at the JAX package's own
tolerances. The CUDA/Triton kernels themselves are checked against these
plain versions on the card by chip_smoke.py."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from basd_tpu_torch.kernels import block_attn, block_mlp, gemm, mix_stack, ns_polar

RNG = np.random.default_rng(7)


def _bf16_pair(shape, scale=1.0):
    """The same bf16 values as a jax array and a torch tensor."""
    a = (RNG.standard_normal(shape) * scale).astype(np.float32)
    j = jnp.asarray(a).astype(jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)


def _f32_pair(shape, scale=1.0, offset=0.0):
    a = (RNG.standard_normal(shape) * scale + offset).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.array(jnp.asarray(t).astype(jnp.float32))


def _block_weights(d, f):
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


def _t(pair):
    """torch side of a pair, transposed to (out, in) for 2-D weights."""
    return pair[1].t().contiguous() if pair[1].dim() == 2 else pair[1]


def test_k1_plain_matches_jax_fused_block_attn():
    from basd_tpu.ops.pallas.fused_block_attn import fused_block_attn

    b, n, d, h = 4, 17, 64, 4
    x = _bf16_pair((b, n, d))
    ln_s, ln_b, wq, bq, wp, bp, *_ = _block_weights(d, 4 * d)
    ref, ref_imp = fused_block_attn(x[0], ln_s[0], ln_b[0], wq[0], bq[0],
                                    wp[0], bp[0], h, 1e-6, True)
    out, imp = block_attn.block_attn_plain(
        x[1], ln_s[1], ln_b[1], _t(wq), bq[1], _t(wp), bp[1], h, 1e-6)
    a, r = _np(out), _np(ref)
    assert np.abs(a - r).max() <= 2 ** -5 * max(np.abs(r).max(), 1.0)
    ri = np.asarray(ref_imp)
    assert np.abs(imp.numpy() - ri).max() <= 2e-2 * ri.max()


def test_k2_plain_matches_jax_fused_ln_mlp_collect():
    from basd_tpu.ops.pallas.fused_block_mlp import fused_ln_mlp_collect

    b, n, d, f, layers, idx = 4, 16, 64, 256, 3, 1
    x = _bf16_pair((b, n, d))
    ln_s, ln_b, *_, w1, b1, w2, b2 = _block_weights(d, f)
    mask = _f32_pair((b,))
    mask_np = np.where(np.asarray(mask[0]) > 0, 1.25, 0.0).astype(np.float32)
    mask = (jnp.asarray(mask_np), torch.from_numpy(mask_np))
    buf = _bf16_pair((layers * b * n, d))
    ref, ref_buf = fused_ln_mlp_collect(
        x[0], mask[0], ln_s[0], ln_b[0], w1[0], b1[0], w2[0], b2[0], buf[0],
        idx, 1e-6, True)
    buf_t = buf[1].clone()
    out = block_mlp.fused_ln_mlp_collect(
        x[1], mask[1], ln_s[1], ln_b[1], _t(w1), b1[1], _t(w2), b2[1], buf_t,
        idx, 1e-6)
    a, r = _np(out), _np(ref)
    assert np.abs(a - r).max() <= 2 ** -5 * max(np.abs(r).max(), 1.0)
    m = b * n
    rows = np.r_[0:idx * m, (idx + 1) * m:layers * m]
    np.testing.assert_array_equal(_np(buf_t)[rows], _np(ref_buf)[rows])
    np.testing.assert_array_equal(_np(buf_t)[idx * m:(idx + 1) * m],
                                  a.reshape(m, d))


# (N, K) of every forward product of the main path (K1/K2 teacher qkv,
# proj, fc1, fc2 at D=384; K3a/K4a/K11a student at D=192) and ragged ones
@pytest.mark.parametrize("n,k,dtype,ptrs,variant,tile_n", [
    (1152, 384, torch.bfloat16, (0, 512, 1024), "sm90", 128),
    (384, 384, torch.bfloat16, (0, 512, 1024), "sm90", 128),
    (1536, 384, torch.bfloat16, (0, 512, 1024), "sm90", 128),
    (384, 1536, torch.bfloat16, (0, 512, 1024), "sm90", 128),
    (576, 192, torch.bfloat16, (0, 512, 1024), "sm90", 128),
    (192, 192, torch.bfloat16, (0, 512, 1024), "sm90", 64),
    (768, 192, torch.bfloat16, (0, 512, 1024), "sm90", 128),
    (192, 768, torch.bfloat16, (0, 512, 1024), "sm90", 64),
    (200, 200, torch.bfloat16, (16, 32, 48), "sm90", 64),   # ragged N, K
    (256, 200, torch.bfloat16, (16, 32, 48), "sm90", 128),
    (64, 8, torch.bfloat16, (0, 0, 0), "sm90", 64),
    (200, 196, torch.bfloat16, (0, 512, 1024), "wmma", 64),  # K % 8 != 0
    (384, 384, torch.bfloat16, (8, 512, 1024), "wmma", 128),  # A unaligned
    (384, 384, torch.bfloat16, (0, 520, 1024), "wmma", 128),  # W unaligned
    (384, 384, torch.bfloat16, (0, 512, 1026), "wmma", 128),  # out unaligned
    (1536, 384, torch.float32, (0, 512, 1024), "f32", 128),
])
def test_gemm_nk_variant(n, k, dtype, ptrs, variant, tile_n):
    """The forward GEMM's dispatch (csrc/gemm_sm90.cuh:gemm_nk_tile_n):
    bf16 with K % 8 == 0 and A, W and out 16-byte aligned take the sm90
    GEMM at a tile width of 128 where N >= 256, else 64."""
    assert gemm.gemm_nk_variant(dtype, n, k, ptrs) == variant
    assert gemm.sm90_tile_n(n) == tile_n


# the backward products of the main path (K3b: dattn, dW_proj, dW_qkv, dxn
# at D=192; K4b/K11b: dW2, the GELU gradient, dW1, dxn/dx at F=768) and
# other leading dimensions, alignments and dtypes
@pytest.mark.parametrize("dtype,lds,ptrs,variant", [
    (torch.bfloat16, (192, 192), (0, 512, 1024), "sm90"),
    (torch.bfloat16, (576, 192), (0, 512, 1024), "sm90"),
    (torch.bfloat16, (192, 768), (0, 512, 1024), "sm90"),
    (torch.bfloat16, (768, 192), (0, 512, 1024), "sm90"),
    (torch.bfloat16, (192, 768), (0, 512, 1024, 2048, 4096), "sm90"),
    (torch.bfloat16, (192, 768), (0, 512, 0, 2048, 0), "sm90"),  # null ptrs
    (torch.bfloat16, (200, 136), (16, 32, 48), "sm90"),
    (torch.bfloat16, (8, 8), (0, 0, 0), "sm90"),
    (torch.bfloat16, (196, 768), (0, 512, 1024), "wmma"),  # lda % 8 != 0
    (torch.bfloat16, (192, 100), (0, 512, 1024), "wmma"),  # ldb % 8 != 0
    (torch.bfloat16, (0, 192), (0, 512, 1024), "wmma"),
    (torch.bfloat16, (192, 768), (8, 512, 1024), "wmma"),  # A unaligned
    (torch.bfloat16, (192, 768), (0, 520, 1024), "wmma"),  # B unaligned
    (torch.bfloat16, (192, 768), (0, 512, 1028), "wmma"),  # out unaligned
    (torch.bfloat16, (192, 768), (0, 512, 1024, 2048, 4098), "wmma"),  # aux
    (torch.float32, (192, 768), (0, 512, 1024), "f32"),
    (torch.float32, (196, 100), (4, 8, 12), "f32"),
])
def test_gemm_bwd_variant(dtype, lds, ptrs, variant):
    """The backward products' dispatch (csrc/block_kernels.cuh:
    gemm_bwd_tile_n): bf16 with both leading dimensions multiples of 8 and
    every operand, output and epilogue address 16-byte aligned take the
    sm90 GEMM, other bf16 the WMMA tile, f32 the CUDA-core tile; the
    GELU-gradient's column-sum rows follow the variant's tile."""
    assert gemm.gemm_bwd_variant(dtype, lds, ptrs) == variant
    assert gemm.gemm_tile_m(variant) == (128 if variant == "sm90" else 64)


@pytest.mark.parametrize("rows,m,n", [
    (25216, 192, 192), (25216, 576, 192), (25216, 192, 768),
    (25216, 768, 192), (50432, 384, 1536), (1576, 192, 768),
    (1000, 200, 200), (129, 65, 24), (64, 8, 8), (1, 8, 8),
    (65, 4096, 4096),
])
def test_split_k_chunk(rows, m, n):
    """The weight gradients' split (csrc/gemm_sm90.cuh:split_k_chunk): each
    chunk a multiple of the 64-row stage, the chunks covering rows
    0..rows-1 once each, in order; no more splits than about SPLIT_TARGET
    CTAs need, at least one, and no empty split; a function of the shapes
    alone."""
    chunk = gemm.split_k_chunk(rows, m, n)
    assert chunk > 0 and chunk % gemm.SM90_TK == 0
    splits = -(-rows // chunk)
    starts = [s * chunk for s in range(splits)]
    ends = [min(rows, s + chunk) for s in starts]
    assert starts[0] == 0 and ends[-1] == rows
    assert all(e == s for e, s in zip(ends[:-1], starts[1:]))
    assert all(s < e for s, e in zip(starts, ends))
    tiles = -(-m // gemm.SM90_TM) * -(-n // gemm.SPLIT_TILE_N)
    assert splits <= max(1, -(-gemm.SPLIT_TARGET // tiles))
    assert gemm.split_k_chunk(rows, m, n) == chunk
    assert gemm.weight_grad_floats(rows, ((m, n),)) == splits * m * n


def test_split_k_chunk_main_path():
    """The splits of the main path's weight gradients (B*N = 25216 rows):
    dW_proj 33 splits of 768 rows, dW_qkv 14 of 1856, dW2 (192 x 768) 9
    of 2816, dW1 (768 x 192) 11 of 2304, about SPLIT_TARGET CTAs each."""
    got = {(m, n): gemm.split_k_chunk(25216, m, n)
           for m, n in ((192, 192), (576, 192), (192, 768), (768, 192))}
    assert got == {(192, 192): 768, (576, 192): 1856, (192, 768): 2816,
                   (768, 192): 2304}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float16])
def test_block_mlp_dtype_rule(dtype):
    """K2/K4's CUDA path takes bf16 and f32 (the weights and the collection
    buffer in x's dtype, the rest f32) and names the entry of each; other
    types raise. A CPU tensor never reaches a kernel."""
    from basd_tpu_torch.kernels import _build

    b, n, d, f = 2, 5, 16, 64
    x = torch.zeros((b, n, d), dtype=dtype)
    w1, w2 = torch.zeros((f, d), dtype=dtype), torch.zeros((d, f), dtype=dtype)
    vec = [torch.zeros(s) for s in (b, d, d, f, d)]
    args = (x, vec[0], vec[1], vec[2], w1, vec[3], w2, vec[4])
    with pytest.raises(ValueError, match="unsupported device"):
        block_mlp._check_mlp("K2", *args)
    if dtype == torch.float16:
        with pytest.raises(ValueError, match="bf16 or f32"):
            block_mlp._mlp_dims("K2", *args)
        return
    buf = ("buf", torch.zeros((3 * b * n, d), dtype=dtype), dtype, (3 * b * n, d))
    block_mlp._mlp_dims("K2", *args, buf)
    for name in ("basd_block_mlp_collect_fwd", "basd_block_mlp_bwd"):
        entry = _build.entry(name, dtype)
        assert entry in _build._SIGNATURES
        assert entry.endswith("_f32") == (dtype == torch.float32)
    other = torch.float32 if dtype == torch.bfloat16 else torch.bfloat16
    with pytest.raises(ValueError, match="expected"):
        block_mlp._mlp_dims("K2", x, *args[1:4], w1.to(other), *args[5:])


L, M, D, P = 12, 512, 48, 4


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6), ("bfloat16", 2e-2)])
def test_k6_plain_fwd_matches_pallas(dtype, tol):
    from basd_tpu.ops.pallas.mix_stack import _mix_fwd_pallas

    w = RNG.standard_normal((P, L)).astype(np.float32)
    t = RNG.standard_normal((L, M, D)).astype(np.float32)
    jd = getattr(jnp, dtype)
    wj, tj = jnp.asarray(w).astype(jd), jnp.asarray(t).astype(jd)
    ref = _mix_fwd_pallas(wj, tj, interpret=True)
    wt = torch.from_numpy(np.array(wj.astype(jnp.float32))).to(getattr(torch, dtype))
    tt = torch.from_numpy(np.array(tj.astype(jnp.float32))).to(getattr(torch, dtype))
    out = mix_stack.mix_fwd_plain(wt, tt)
    assert out.dtype == tt.dtype
    np.testing.assert_allclose(_np(out), _np(ref), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 5e-3)])
def test_k6_plain_dw_matches_pallas(dtype, tol):
    from basd_tpu.ops.pallas.mix_stack import _dw_pallas

    jd = getattr(jnp, dtype)
    tj = jnp.asarray(RNG.standard_normal((L, M, D)).astype(np.float32)).astype(jd)
    gj = jnp.asarray(RNG.standard_normal((P, M, D)).astype(np.float32)).astype(jd)
    ref = np.asarray(_dw_pallas(gj, tj, interpret=True))
    tt = torch.from_numpy(_np(tj)).to(getattr(torch, dtype))
    gt = torch.from_numpy(_np(gj)).to(getattr(torch, dtype))
    dw = mix_stack.mix_dw_plain(gt, tt).numpy()
    scale = np.abs(ref).max()
    np.testing.assert_allclose(dw, ref, rtol=tol, atol=tol * scale)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 5e-3)])
def test_k6_autograd_dw_matches_jax_grad(dtype, tol):
    from basd_tpu.ops.pallas.mix_stack import mix_stack as jax_mix_stack

    jd = getattr(jnp, dtype)
    wj = jnp.asarray(RNG.standard_normal((P, L)).astype(np.float32)).astype(jd)
    tj = jnp.asarray(RNG.standard_normal((L, M, D)).astype(np.float32)).astype(jd)
    gj = jnp.asarray(RNG.standard_normal((P, M, D)).astype(np.float32))
    ref = jax.grad(lambda w: jnp.sum(
        jax_mix_stack(w, tj).astype(jnp.float32) * gj))(wj)
    wt = torch.from_numpy(_np(wj)).to(getattr(torch, dtype)).requires_grad_(True)
    tt = torch.from_numpy(_np(tj)).to(getattr(torch, dtype))
    out = mix_stack.mix_stack(wt, tt)
    (out.float() * torch.from_numpy(np.array(gj))).sum().backward()
    scale = np.abs(_np(ref)).max()
    np.testing.assert_allclose(_np(wt.grad), _np(ref), rtol=tol, atol=tol * scale)


def test_k7_plain_matches_pallas_on_decaying_spectrum():
    from basd_tpu.ops.pallas.ns_polar import (
        _QUINTIC_SCHEDULE,
        ns_polar_hybrid as jax_ns_polar_hybrid,
    )

    assert tuple(ns_polar.QUINTIC_SCHEDULE) == tuple(_QUINTIC_SCHEDULE)
    rng = np.random.default_rng(11)
    b, r, c = 5, 16, 128
    u = np.linalg.qr(rng.standard_normal((b, r, r)))[0]
    v = np.linalg.qr(rng.standard_normal((b, c, c)))[0][:, :, :r]
    s = np.logspace(0, -2, r)
    m = np.einsum("bik,k,bjk->bij", u, s, v).astype(np.float32)
    ref = np.asarray(jax_ns_polar_hybrid(jnp.asarray(m), interpret=True)
                     .astype(jnp.float32))
    out = ns_polar.ns_polar_plain(torch.from_numpy(m))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(out), ref, atol=3e-2)
    p = _np(out).astype(np.float64)
    np.testing.assert_allclose(np.einsum("bik,bjk->bij", p, p),
                               np.broadcast_to(np.eye(r), (b, r, r)), atol=5e-2)
