"""Boundaries of the PyTorch port: it never imports jax, and on CPU tensors
every kernel wrapper returns its plain result without launching."""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

PKG = Path(__file__).resolve().parent.parent / "basd_tpu_torch"


def test_port_import_leaves_jax_out():
    code = (
        "import sys\n"
        "import basd_tpu_torch, basd_tpu_torch.train\n"
        "import basd_tpu_torch.kernels, basd_tpu_torch.models.port\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "assert 'triton' not in sys.modules\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=PKG.parent, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_no_jax_import_in_port_sources():
    offenders = [
        str(p) for p in PKG.rglob("*.py")
        if any(line.strip().startswith(("import jax", "from jax"))
               for line in p.read_text().splitlines())
    ]
    assert offenders == []


def _wrapper_cases():
    from basd_tpu_torch.kernels import block_attn, block_mlp, mix_stack, ns_polar

    rng = np.random.default_rng(3)

    def t(*shape, dtype=torch.float32, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32)).to(dtype)

    b, n, d, h, f = 2, 9, 32, 4, 128
    bf = torch.bfloat16
    x = t(b, n, d, dtype=bf)
    ln = (t(d) * 0.1 + 1.0, t(d) * 0.1)
    attn = (t(3 * d, d, dtype=bf, scale=0.2), t(3 * d), t(d, d, dtype=bf, scale=0.2), t(d))
    mlp = (t(f, d, dtype=bf, scale=0.2), t(f), t(d, f, dtype=bf, scale=0.2), t(d))
    ones = torch.ones(b)
    w, stack, g = t(4, 3, dtype=bf), t(3, b * n, d, dtype=bf), t(4, b * n, d, dtype=bf)
    polar_in = t(3, 8, 128)
    buf = torch.zeros(3 * b * n, d, dtype=bf)
    return [
        ("K1", block_attn.fused_block_attn, (x, *ln, *attn, h),
         lambda: block_attn.block_attn_plain(x, *ln, *attn, h)),
        ("K2", block_mlp.fused_ln_mlp_collect, (x, ones, *ln, *mlp, buf, 1),
         lambda: block_mlp.block_mlp_plain(x, ones, *ln, *mlp)),
        ("K6a", mix_stack.mix_stack_fwd, (w, stack),
         lambda: mix_stack.mix_fwd_plain(w, stack)),
        ("K6b", mix_stack.mix_stack_dw, (g, stack),
         lambda: mix_stack.mix_dw_plain(g, stack)),
        ("K7", ns_polar.ns_polar_hybrid, (polar_in,),
         lambda: ns_polar.ns_polar_plain(polar_in)),
    ]


@pytest.mark.parametrize("case", range(5))
def test_wrapper_on_cpu_is_plain_and_uncounted(case):
    name, wrapper, args, plain = _wrapper_cases()[case]
    before = wrapper.launches
    out = wrapper(*args)
    ref = plain()
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    for a, b in zip(outs, refs):
        assert torch.equal(a, b), name
    assert wrapper.launches == before == 0, name
