"""The forward attention core of the port (``csrc/attention.cuh``) and K10/K11
at f32, as far as the CPU reaches them.

- The plain versions of K10 (``flash_attention_plain_fwd`` / ``_imp`` /
  ``_bwd``), which ``chip_smoke.py`` holds the CUDA kernels to, against the
  JAX package's ``flash_attention_qkv(_with_importance)`` kernels in
  interpret mode at the slice's real widths (N=197; the student's D=192
  with 3 heads, the DeiT-S teacher's D=384 with 6), bf16 and f32, B=2.
- The dispatch between the tensor-core and the CUDA-core kernels of the
  forward and the backward attention cores and the shared memory each
  needs, as pure functions.
- The type rules of the CUDA paths of K10 and K11, split from their device
  check, so that an f32 tensor is seen to reach the kernels' entries; and
  the ctypes signatures of every entry against its C declaration.

Tolerances, as ``tests/test_torch_flash_mlp.py`` holds K10 at N <= 17: f32
outputs within 5e-6 of max(|ref|, 1) and bf16 ones within 2^-5 of it (one
bf16 rounding of the largest value); lse within 1e-5 of max(|ref|, 1); the
importance within 1e-6 absolute (f32 softmax rows); dqkv within 1e-5 (f32)
or 2^-5 (bf16) of max(|ref|, 1).
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from basd_tpu_torch.kernels import _build
from basd_tpu_torch.kernels import block_attn as ba
from basd_tpu_torch.kernels import flash_attention as fa
from basd_tpu_torch.kernels import fused_mlp as fm

RNG = np.random.default_rng(31)
N = 197
WIDTHS = [(192, 3), (384, 6)]  # (D, heads): the student's and DeiT-S's


def _pair(shape, dtype):
    """The same values as a jax array and a torch tensor, in ``dtype``."""
    a = RNG.standard_normal(shape).astype(np.float32)
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


def _out_rel(dtype):
    return 5e-6 if dtype == "float32" else 2 ** -5


def _attention_f64(qkv, h: int, scale: float):
    """softmax(scale q k^T) v over the (B, N, 3D) slab in float64 numpy,
    unrounded: a third party to the port and the JAX kernel, each of which
    lies one f32 (or bf16) rounding from it."""
    b, n, d3 = qkv.shape
    q, k, v = (t.reshape(b, n, h, -1).transpose(0, 2, 1, 3)
               for t in np.split(np.asarray(qkv, np.float64), 3, axis=-1))
    s = q @ k.transpose(0, 1, 3, 2) * scale
    p = np.exp(s - s.max(-1, keepdims=True))
    o = (p @ v) / p.sum(-1, keepdims=True)
    return o.transpose(0, 2, 1, 3).reshape(b, n, d3 // 3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,h", WIDTHS)
def test_plain_fwd_matches_jax_full_width(dtype, d, h):
    """Each side is first held to the float64 attention of the same inputs,
    at the same tolerance, so that a disagreement names the side that moved
    (one parallel run of the suite read 2.8e-5 here once, at f32, D=192,
    and no rerun has shown it again)."""
    from basd_tpu.ops.pallas import flash_attention as jfa

    e = d // h
    qkv = _pair((2, N, 3 * d), dtype)
    scale = float(e ** -0.5)
    j_o, j_lse = jfa._fwd(qkv[0], N, h, e, scale, True)
    o, lse = fa.flash_attention_plain_fwd(qkv[1], h, scale)
    assert o.dtype == qkv[1].dtype and lse.dtype == torch.float32
    ref = _attention_f64(_np(qkv[1]), h, scale)
    _close(o, ref, _out_rel(dtype), 1.0, "K10a o, the port against float64")
    _close(j_o, ref, _out_rel(dtype), 1.0, "K10a o, basd_tpu against float64")
    _close(o, j_o, _out_rel(dtype), 1.0, "K10a o")
    _close(lse, j_lse, 1e-5, 1.0, "K10a lse")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,h", WIDTHS)
def test_plain_imp_matches_jax_full_width(dtype, d, h):
    """Odd h takes the JAX head-loop kernel, even h the head-pair one."""
    from basd_tpu.ops.pallas import flash_attention as jfa

    qkv = _pair((2, N, 3 * d), dtype)
    scale = float((d // h) ** -0.5)
    j_o, j_imp = jfa.flash_attention_qkv_with_importance(qkv[0], h, scale,
                                                         True)
    o, imp = fa.flash_attention_plain_imp(qkv[1], h, scale)
    _close(o, j_o, _out_rel(dtype), 1.0, "K10c o")
    assert imp.dtype == torch.float32 and imp.shape == (2, N)
    np.testing.assert_allclose(_np(imp), _np(j_imp), rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,h", WIDTHS)
def test_plain_bwd_matches_jax_full_width(dtype, d, h):
    from basd_tpu.ops.pallas import flash_attention as jfa

    e = d // h
    qkv = _pair((2, N, 3 * d), dtype)
    cot = _pair((2, N, d), dtype)
    scale = float(e ** -0.5)
    j_o, j_lse = jfa._fwd(qkv[0], N, h, e, scale, True)
    j_dqkv = jfa._bwd(qkv[0], j_o, cot[0], j_lse, N, h, e, scale, True)
    o, lse = fa.flash_attention_plain_fwd(qkv[1], h, scale)
    dqkv = fa.flash_attention_plain_bwd(qkv[1], o, cot[1], lse, h, scale)
    assert dqkv.dtype == qkv[1].dtype
    _close(dqkv, j_dqkv, 1e-5 if dtype == "float32" else 2 ** -5, 1.0,
           "K10b dqkv")


@pytest.mark.parametrize("dtype,e,variant", [
    (torch.bfloat16, 64, "tc"),    # every preset of models/registry.py
    (torch.bfloat16, 16, "tc"),
    (torch.bfloat16, 48, "tc"),
    (torch.bfloat16, 128, "tc"),
    (torch.bfloat16, 24, "simt"),  # even, not a multiple of 16
    (torch.bfloat16, 8, "simt"),
    (torch.bfloat16, 144, "simt"),
    (torch.float32, 64, "simt"),   # every f32 slab
    (torch.float32, 16, "simt"),
])
def test_attention_core_dispatch(dtype, e, variant):
    assert ba.attn_fwd_variant(dtype, e) == variant


@pytest.mark.parametrize("n,e,variant,itemsize,expected", [
    # K and V of one (image, head), rows padded to 16, E + 8 bf16 wide
    (197, 64, "tc", 2, 2 * 208 * 72 * 2),    # ~60 KB: 3 CTAs an SM
    (257, 64, "tc", 2, 2 * 272 * 72 * 2),    # ~78 KB: 2 CTAs an SM
    # K, V and 8 warps' score and q rows at f32: K10's f32 forward
    (197, 64, "simt", 4, 197 * 66 * 4 + 197 * 64 * 4 + 8 * 261 * 4),
    (257, 64, "simt", 4, 257 * 66 * 4 + 257 * 64 * 4 + 8 * 321 * 4),
])
def test_attention_core_smem_fits(n, e, variant, itemsize, expected):
    smem = ba._attn_fwd_smem(n, e, variant, itemsize)
    assert smem == expected
    assert smem <= ba._SMEM_PER_BLOCK
    ba._check_smem("test", smem, n, e)


@pytest.mark.parametrize("dtype,e,variant", [
    (torch.bfloat16, 64, "tc"),    # K3b and K10b at every registry preset
    (torch.bfloat16, 32, "tc"),
    (torch.bfloat16, 128, "tc"),
    (torch.bfloat16, 24, "simt"),  # even, not a multiple of 16
    (torch.bfloat16, 144, "simt"),
    (torch.float32, 64, "simt"),   # K10b at f32
])
def test_attention_bwd_dispatch(dtype, e, variant):
    assert ba.attn_bwd_variant(dtype, e) == variant


@pytest.mark.parametrize("n,e,variant,itemsize,fits", [
    # tensor cores: 64-key and 64-query blocks, the same bytes at any N
    (197, 64, "tc", 2, True),
    (257, 64, "tc", 2, True),
    (4096, 64, "tc", 2, True),
    (197, 128, "tc", 2, True),
    # CUDA cores: two of q, k, v and do of one (image, head) per launch;
    # f32 at N=257, E=64 (dinov2_vitb14's tokens) fits
    (197, 64, "simt", 4, True),
    (257, 64, "simt", 4, True),
    (197, 24, "simt", 2, True),
    (1024, 64, "simt", 4, False),
])
def test_flash_bwd_smem(n, e, variant, itemsize, fits):
    """The backward's shared memory (K10b's and K3b's attention): constant
    in N on tensor cores, linear in N on CUDA cores."""
    smem = ba._attn_bwd_smem(n, e, variant, itemsize)
    if variant == "tc":
        assert smem == (6 * 64 * (e + 8) * 2 + 2 * 64 * 72 * 2 + 4 * 64 * 4
                        + 8 * e * 4)
    else:
        assert smem == (2 * n * (e + 2) * itemsize + 2 * n * 4
                        + 8 * (2 * (e + 2) * itemsize + 2 * n * 4 + 2 * e * 4))
    if fits:
        ba._check_smem("K10b", smem, n, e)
    else:
        with pytest.raises(ValueError, match="shared memory"):
            ba._check_smem("K10b", smem, n, e)


def test_attention_bwd_checked_variant_alignment():
    checked = ba._attn_bwd_variant_checked
    assert checked("K", torch.bfloat16, 257, 64, (256, 512)) == "tc"
    assert checked("K", torch.float32, 257, 64, (4, 8)) == "simt"
    with pytest.raises(ValueError, match="16-byte aligned"):
        checked("K", torch.bfloat16, N, 64, (256, 8))
    with pytest.raises(ValueError, match="shared memory"):
        checked("K", torch.float32, 1024, 64, ())


def test_attention_core_checked_variant_alignment():
    checked = ba._attn_fwd_variant_checked
    assert checked("K", torch.bfloat16, N, 64, 256) == "tc"
    assert checked("K", torch.float32, N, 64, 4) == "simt"
    with pytest.raises(ValueError, match="16-byte aligned"):
        checked("K", torch.bfloat16, N, 64, 8)
    with pytest.raises(ValueError, match="shared memory"):
        checked("K", torch.float32, 4096, 64, 0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float16])
def test_flash_slab_dtype_rule(dtype):
    """bf16 and f32 pass the type rules of K10's CUDA path (and name their
    entries); other types raise. A CPU tensor never reaches a kernel."""
    b, d, h = 2, 192, 3
    qkv = torch.zeros((b, N, 3 * d), dtype=dtype)
    o = torch.zeros((b, N, d), dtype=dtype)
    lse = torch.zeros((b, h, N))
    others = [("o", o, dtype, (b, N, d)), ("dout", o, dtype, (b, N, d)),
              ("lse", lse, torch.float32, (b, h, N))]
    with pytest.raises(ValueError, match="unsupported device"):
        fa._check_slab("K10", qkv, h)
    if dtype == torch.float16:
        with pytest.raises(ValueError, match="bf16 or f32"):
            fa._slab_dims("K10", qkv, h)
        return
    assert fa._slab_dims("K10", qkv, h, others) == (b, N, d, d // h)
    for name in ("basd_flash_attn_fwd", "basd_flash_attn_imp",
                 "basd_flash_attn_bwd"):
        entry = _build.entry(name, dtype)
        assert entry in _build._SIGNATURES
        assert entry.endswith("_f32") == (dtype == torch.float32)
    other = torch.float32 if dtype == torch.bfloat16 else torch.bfloat16
    with pytest.raises(ValueError, match="expected"):  # o in another type
        fa._slab_dims("K10", qkv, h, [("o", o.to(other), dtype, (b, N, d))])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float16])
def test_mlp_dtype_rule(dtype):
    """bf16 and f32 pass the type rules of K11's CUDA path, the weights in
    x's type and the biases f32; other types raise."""
    b, d, f = 2, 192, 768
    x = torch.zeros((b, N, d), dtype=dtype)
    w1, w2 = torch.zeros((f, d), dtype=dtype), torch.zeros((d, f), dtype=dtype)
    b1 = torch.zeros(f)
    with pytest.raises(ValueError, match="unsupported device"):
        fm._check_mlp("K11", x, w1, b1, w2)
    if dtype == torch.float16:
        with pytest.raises(ValueError, match="bf16 or f32"):
            fm._mlp_dims("K11", x, w1, b1, w2)
        return
    dout = ("dout", x, dtype, (b, N, d))
    assert fm._mlp_dims("K11", x, w1, b1, w2, dout) == (b * N, d, f, d)
    for name in ("basd_fused_mlp_fwd", "basd_fused_mlp_bwd"):
        assert _build.entry(name, dtype) in _build._SIGNATURES
    other = torch.float32 if dtype == torch.bfloat16 else torch.bfloat16
    with pytest.raises(ValueError, match="expected"):
        fm._mlp_dims("K11", x, w1.to(other), b1, w2)


def _c_declarations() -> dict[str, list[str]]:
    """Each ``extern "C" int name(...)`` of csrc/*.cu: its parameters."""
    out = {}
    for path in sorted(_build.CSRC_DIR.glob("*.cu")):
        text = Path(path).read_text()
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text):
            out[m.group(1)] = [p.strip() for p in m.group(2).split(",")]
    return out


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_entry_signature_matches_c(name):
    """The ctypes argument types of every entry match its C declaration:
    a pointer for each pointer (and the stream), c_int for each int,
    c_float for each float. A mismatch would pass ints for pointers."""
    decl = _c_declarations()
    assert name in decl, f"{name} has no extern C declaration in csrc"
    kinds = ["p" if "*" in p else "i" if p.startswith("int ") else "f"
             for p in decl[name]]
    expected = ["p" if t is _build._P else "i" if t is _build._I else "f"
                for t in _build._SIGNATURES[name]]
    assert kinds == expected
