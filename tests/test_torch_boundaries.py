"""Boundaries of the PyTorch port: it never imports jax or the JAX package
``basd_tpu``, and on CPU tensors every kernel wrapper returns its plain
result without launching."""

from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from basd_tpu_torch.kernels import KERNELS

PKG = Path(__file__).resolve().parent.parent / "basd_tpu_torch"
SMOKE = PKG.parent / "chip_smoke.py"
_FORBIDDEN_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|basd_tpu)(\.|\s|$)")


def test_port_import_leaves_jax_out():
    code = (
        "import sys\n"
        "import basd_tpu_torch, basd_tpu_torch.train\n"
        "import basd_tpu_torch.kernels, basd_tpu_torch.models.port\n"
        "import basd_tpu_torch.data.cache, basd_tpu_torch.data.native\n"
        "import chip_smoke\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "ref = sorted(m for m in sys.modules\n"
        "             if m == 'basd_tpu' or m.startswith('basd_tpu.'))\n"
        "assert not ref, ref\n"
        "assert 'triton' not in sys.modules\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=PKG.parent, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_no_jax_import_in_port_sources():
    offenders = [
        f"{p}:{i}" for p in [*PKG.rglob("*.py"), SMOKE]
        for i, line in enumerate(p.read_text().splitlines(), 1)
        if _FORBIDDEN_IMPORT.match(line)
    ]
    assert offenders == []


def _wrapper_cases():
    from basd_tpu_torch.kernels import (
        block_attn,
        block_mlp,
        flash_attention,
        fused_mlp,
        geom_shift,
        layernorm,
        mix_stack,
        ns_polar,
    )
    from basd_tpu_torch.kernels.converged_eigh import converged_eigh_plain
    from basd_tpu_torch.kernels.jacobi_eigh import jacobi_eigh_plain as jacobi_plain
    from basd_tpu_torch.models.port import shard_state_dict
    from basd_tpu_torch.parallel.mesh import ModelParallel

    rng = np.random.default_rng(3)

    def t(*shape, dtype=torch.float32, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32)).to(dtype)

    b, n, d, h, f = 2, 9, 32, 4, 128
    bf = torch.bfloat16
    x = t(b, n, d, dtype=bf)
    dout = t(b, n, d, dtype=bf)
    ln = (t(d) * 0.1 + 1.0, t(d) * 0.1)
    attn = (t(3 * d, d, dtype=bf, scale=0.2), t(3 * d), t(d, d, dtype=bf, scale=0.2), t(d))
    mlp = (t(f, d, dtype=bf, scale=0.2), t(f), t(d, f, dtype=bf, scale=0.2), t(d))
    ones = torch.ones(b)
    mask = torch.tensor([1.25, 0.0])
    lse = block_attn.block_attn_train_plain_fwd(x, mask, *ln, *attn, h)[1]
    mu, rstd = layernorm.layernorm_plain_fwd(x, *ln)[1:]
    w, stack, g = t(4, 3, dtype=bf), t(3, b * n, d, dtype=bf), t(4, b * n, d, dtype=bf)
    polar_in = t(3, 8, 128)
    sym = t(2, 8, 8)
    sym = (sym + sym.transpose(1, 2)) / 2
    buf = torch.zeros(3 * b * n, d, dtype=bf)
    imgs = torch.from_numpy(rng.integers(0, 256, (3, 8, 10, 3), dtype=np.uint8))
    r_h = torch.from_numpy(rng.integers(-3, 4, (3, 8)))
    r_w = torch.from_numpy(rng.integers(-3, 4, (3, 10)))
    k3b = (x, mask, dout, lse, *ln, *attn[:3], h)
    k4b = (x, mask, dout, *ln, *mlp[:3])
    qkv = t(b, n, 3 * d, dtype=bf)
    o, lse10 = flash_attention.flash_attention_plain_fwd(qkv, h, 0.25)
    k10b = (qkv, o, dout, lse10, h, 0.25)
    k11b = (x, dout, *mlp[:3])
    # rank 1 of 2's shards (heads 2-3 of 4, E = 8; hidden units 64-127)
    names = ("attn.qkv.weight", "attn.qkv.bias", "attn.proj.weight",
             "mlp.fc1.weight", "mlp.fc1.bias", "mlp.fc2.weight")
    shard = shard_state_dict(
        {"blocks.0." + k: v for k, v in zip(names, attn[:3] + mlp[:3])},
        ModelParallel(1, 2), h)
    attn_r = tuple(shard["blocks.0." + k] for k in names[:3])
    mlp_r = tuple(shard["blocks.0." + k] for k in names[3:])
    lse_r = block_attn.block_attn_train_plain_fwd_partial(x, *ln, *attn_r, 2,
                                                          8)[1]
    k3bp = (x, mask, dout, lse_r, *ln, *attn_r, 2, 8)
    k4bp = (x, mask, dout, *ln, *mlp_r)
    # K2g's SwiGLU MLP: fc1 (2 F, D) packed [a | g]
    swiglu = (t(2 * f, d, dtype=bf, scale=0.2), t(2 * f),
              t(d, f, dtype=bf, scale=0.2), t(d))

    def flat_bwd(grads):
        """A plain backward's (dx, 3 weight grads, bias, dln_s, dln_b) as
        the partial wrappers return it: (flat [dx, dln_s, dln_b], 3)."""
        dx, g1, g2, g3, _, dls, dlb = grads
        return torch.cat([dx.reshape(-1), dls, dlb]), g1, g2, g3

    return {
        "K1 fused_block_attn: partial": (
            (x, *ln, *attn_r, 2, 8, h),
            lambda: torch.cat([t_.reshape(-1) for t_ in
                               block_attn.block_attn_plain_partial(
                                   x, *ln, *attn_r, 2, 8, h)])),
        "K2 fused_ln_mlp_collect: partial": (
            (x, *ln, *mlp_r),
            lambda: block_mlp.block_mlp_plain_partial(x, *ln, *mlp_r)),
        "K3a fused_block_attn_train fwd: partial": (
            (x, *ln, *attn_r, 2, 8),
            lambda: block_attn.block_attn_train_plain_fwd_partial(
                x, *ln, *attn_r, 2, 8)),
        "K3b fused_block_attn_train bwd: partial": (
            k3bp, lambda: flat_bwd(block_attn.block_attn_train_plain_bwd(
                *k3bp[:-2], 2, 1e-6, 8, partial=True))),
        "K4a fused_ln_mlp fwd: partial": (
            (x, *ln, *mlp_r),
            lambda: block_mlp.block_mlp_plain_partial(x, *ln, *mlp_r)),
        "K4b fused_ln_mlp bwd: partial": (
            k4bp, lambda: flat_bwd(block_mlp.block_mlp_plain_bwd(
                *k4bp, partial=True))),
        "K11a fused_mlp fwd: partial": (
            (x, *mlp_r),
            lambda: fused_mlp.fused_mlp_plain_fwd(x, *mlp_r, None)),
        "K11b fused_mlp bwd: partial": (
            (x, dout, *mlp_r),
            lambda: fused_mlp.fused_mlp_plain_bwd(x, dout, *mlp_r,
                                                  partial=True)[:4]),
        "K1 fused_block_attn": (
            (x, *ln, *attn, h),
            lambda: block_attn.block_attn_plain(x, *ln, *attn, h)),
        "K2 fused_ln_mlp_collect": (
            (x, ones, *ln, *mlp, buf, 1),
            lambda: block_mlp.block_mlp_plain(x, ones, *ln, *mlp)),
        "K3a fused_block_attn_train fwd": (
            (x, mask, *ln, *attn, h),
            lambda: block_attn.block_attn_train_plain_fwd(x, mask, *ln, *attn, h)),
        "K3b fused_block_attn_train bwd": (
            k3b, lambda: block_attn.block_attn_train_plain_bwd(*k3b)),
        "K4a fused_ln_mlp fwd": (
            (x, mask, *ln, *mlp),
            lambda: block_mlp.block_mlp_plain(x, mask, *ln, *mlp)),
        "K4b fused_ln_mlp bwd": (
            k4b, lambda: block_mlp.block_mlp_plain_bwd(*k4b)),
        "K5a fused_layernorm fwd": (
            (x, *ln), lambda: layernorm.layernorm_plain_fwd(x, *ln)),
        "K5b fused_layernorm bwd": (
            (x, ln[0], mu, rstd, dout),
            lambda: layernorm.layernorm_plain_bwd(x, ln[0], mu, rstd, dout)),
        "K6a mix_stack fwd": (
            (w, stack), lambda: mix_stack.mix_fwd_plain(w, stack)),
        "K6b mix_stack dw": (
            (g, stack), lambda: mix_stack.mix_dw_plain(g, stack)),
        "K7 ns_polar_hybrid": (
            (polar_in,), lambda: ns_polar.ns_polar_plain(polar_in)),
        "K8 jacobi_eigh": (
            (sym, 6), lambda: jacobi_plain(sym, 6)),
        "K8 converged": (
            (sym,), lambda: converged_eigh_plain(sym)),
        "K9 geom_shift3": (
            (imgs, r_h, r_w, r_h.flip(0)),
            lambda: geom_shift.geom_shift3_plain(imgs, r_h, r_w, r_h.flip(0))),
        "K10a flash_attention fwd": (
            (qkv, h, 0.25),
            lambda: flash_attention.flash_attention_plain_fwd(qkv, h, 0.25)),
        "K10b flash_attention bwd": (
            k10b, lambda: flash_attention.flash_attention_plain_bwd(*k10b)),
        "K10c flash_attention importance": (
            (qkv, h, 0.25),
            lambda: flash_attention.flash_attention_plain_imp(qkv, h, 0.25)),
        "K11a fused_mlp fwd": (
            (x, *mlp), lambda: fused_mlp.fused_mlp_plain_fwd(x, *mlp)),
        "K11b fused_mlp bwd": (
            k11b, lambda: fused_mlp.fused_mlp_plain_bwd(*k11b)),
        "K2g fused_ln_swiglu_collect": (
            (x, ones, *ln, *swiglu, buf, 1),
            lambda: block_mlp.swiglu_mlp_plain(x, ones, *ln, *swiglu)),
    }


@pytest.mark.parametrize("case", range(len(KERNELS)))
def test_wrapper_on_cpu_is_plain_and_uncounted(case):
    name, *_, wrapper = KERNELS[case]
    args, plain = _wrapper_cases()[name]
    before = wrapper.launches
    out = wrapper(*args)
    ref = plain()
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    assert len(outs) == len(refs), name
    for a, b in zip(outs, refs):
        assert torch.equal(a, b), name
    assert wrapper.launches == before == 0, name
