"""Digests of the whole block kernels' outputs, on one tree's port.

    python3 scripts/kernel_digest.py [ROOT]

On one CUDA GPU, with ROOT's ``basd_tpu_torch`` (default: this checkout;
e.g. a parent unpacked with ``git archive`` under ``build/``), calls K1,
K2 (with its collection slab), K3a, K3b, K4a, K4b, K10a, K10b, K10c, K11a
and K11b through their wrappers on inputs drawn from a generator seeded 0
at the train step's shapes (B=128, N=197; the DeiT-S teacher's D=384, 6
heads, F=1536 for K1, K2 and K10c, the student's D=192, 3 heads, F=768 for
the others), and K4a, K4b, K11a and K11b's f32 entries at B=8; prints
one JSON line, the SHA-256 of each kernel's output bytes. Two trees whose
lines are equal computed the same bits. Uses only the wrappers' signatures
that every tree since the sm90 GEMM has had.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("root", nargs="?", default=str(HERE))
    args = parser.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))

    import torch

    if not torch.cuda.is_available():
        print("kernel_digest: no CUDA device", file=sys.stderr)
        return 1
    from basd_tpu_torch.kernels import (
        block_attn,
        block_mlp,
        flash_attention,
        fused_mlp,
    )

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    bf, f32 = torch.bfloat16, torch.float32

    def rn(*shape, scale=1.0, dtype=f32):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    def weights(d, f, dtype):
        return ((1.0 + 0.1 * rn(d), 0.1 * rn(d)),
                (rn(3 * d, d, scale=d ** -0.5, dtype=dtype), 0.1 * rn(3 * d),
                 rn(d, d, scale=d ** -0.5, dtype=dtype), 0.1 * rn(d)),
                (rn(f, d, scale=d ** -0.5, dtype=dtype), 0.1 * rn(f),
                 rn(d, f, scale=f ** -0.5, dtype=dtype), 0.1 * rn(d)))

    def digest(*outs) -> str:
        h = hashlib.sha256()
        for t in outs:
            h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy()
                     .tobytes())
        return h.hexdigest()

    b, n = 128, 197
    out = {}
    x = rn(b, n, 384, dtype=bf)
    ln, attn, mlp = weights(384, 1536, bf)
    ones = torch.ones(b, device=dev)
    out["K1"] = digest(*block_attn.fused_block_attn(x, *ln, *attn, 6))
    buf = torch.zeros((2 * b * n, 384), dtype=bf, device=dev)
    out["K2"] = digest(block_mlp.fused_ln_mlp_collect(x, ones, *ln, *mlp, buf,
                                                      1), buf)
    out["K10c"] = digest(*flash_attention.flash_attention_imp(
        rn(b, n, 3 * 384, dtype=bf), 6, 64 ** -0.5))

    xs = rn(b, n, 192, dtype=bf)
    ln, attn, mlp = weights(192, 768, bf)
    mask = torch.where(torch.rand(b, generator=g, device=dev) < 0.9,
                       torch.tensor(1 / 0.9, device=dev),
                       torch.tensor(0.0, device=dev))
    dout = rn(b, n, 192, dtype=bf)
    o3, lse = block_attn.fused_block_attn_train_fwd(xs, mask, *ln, *attn, 3)
    out["K3a"] = digest(o3, lse)
    out["K3b"] = digest(*block_attn.fused_block_attn_train_bwd(
        xs, mask, dout, lse, *ln, *attn[:3], 3))
    out["K4a"] = digest(block_mlp.fused_ln_mlp_fwd(xs, mask, *ln, *mlp))
    out["K4b"] = digest(*block_mlp.fused_ln_mlp_bwd(xs, mask, dout, *ln,
                                                    *mlp[:3]))
    out["K11a"] = digest(fused_mlp.fused_mlp_fwd(xs, *mlp))
    out["K11b"] = digest(*fused_mlp.fused_mlp_bwd(xs, dout, *mlp[:3]))
    qkv = rn(b, n, 3 * 192, dtype=bf)
    o10, lse10 = flash_attention.flash_attention_fwd(qkv, 3, 64 ** -0.5)
    out["K10a"] = digest(o10, lse10)
    out["K10b"] = digest(flash_attention.flash_attention_bwd(
        qkv, o10, dout, lse10, 3, 64 ** -0.5))

    # the f32 entries of K2/K4 and K11
    bs = 8
    x32 = rn(bs, n, 192)
    ln, _, mlp = weights(192, 768, f32)
    m32 = torch.ones(bs, device=dev)
    do32 = rn(bs, n, 192)
    out["K4a f32"] = digest(block_mlp.fused_ln_mlp_fwd(x32, m32, *ln, *mlp))
    out["K4b f32"] = digest(*block_mlp.fused_ln_mlp_bwd(x32, m32, do32, *ln,
                                                        *mlp[:3]))
    out["K11a f32"] = digest(fused_mlp.fused_mlp_fwd(x32, *mlp))
    out["K11b f32"] = digest(*fused_mlp.fused_mlp_bwd(x32, do32, *mlp[:3]))
    torch.cuda.synchronize()
    print(json.dumps({"root": str(Path(args.root).resolve()), **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
