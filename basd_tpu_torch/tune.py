"""Device-time sweeps behind the tuned constants of the port's kernels.

    python -m basd_tpu_torch.tune [--out FILE]

Runs on one CUDA GPU (it exits non-zero without one) and prints one line per
measurement, and with ``--out`` writes them as JSON:

1. K5b (``kernels/layernorm.py``): rows per step x warps per row program
   (``_BWD_ELEMS``, ``_BWD_WARPS``) at the student's (128, 197, 192), at D=256
   (the same rows, no masked lanes: 192 is padded to a block of 256) and at
   the teacher's D=384; aten's LayerNorm backward beside them.
2. The forward GEMM (``csrc/gemm_sm90.cuh`` against ``common.cuh``'s WMMA
   tile) at every (M, N, K) of the main path's forward products, B=128:
   the WMMA tile, the sm90 GEMM at tile widths 64 and 128, and
   ``torch.nn.functional.linear`` as a yardstick (never called by the
   port).

Each configuration is timed two ways: ``device_ms``, a CUDA graph of 20
calls replayed 5 times (the median replay over 20: device time without the
host's dispatch), and ``eager_ms``, CUDA events around 20 back-to-back
calls (what a caller sees, dispatch included).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys


def _device_ms(torch, fn, calls: int = 20, replays: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def _eager_ms(torch, fn, calls: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def _times(torch, fn) -> dict:
    return {"device_ms": _device_ms(torch, fn), "eager_ms": _eager_ms(torch, fn)}


def ln_bwd_sweep(torch, device, rows_list=(8, 16, 32, 64),
                 warps_list=(2, 4, 8)) -> list:
    from basd_tpu_torch.kernels import layernorm

    out = []
    g = torch.Generator(device=device).manual_seed(0)
    for d in (192, 256, 384):
        x = torch.randn((128, 197, d), generator=g, device=device).to(torch.bfloat16)
        dy = torch.randn((128, 197, d), generator=g, device=device).to(torch.bfloat16)
        scale = 1.0 + 0.1 * torch.randn(d, generator=g, device=device)
        bias = 0.1 * torch.randn(d, generator=g, device=device)
        _, mu, rstd = layernorm.layernorm_fwd(x, scale, bias)
        moved = 3 * x.numel() * 2 + 2 * mu.numel() * 4
        for rows in rows_list:
            for warps in warps_list:
                rec = {"kernel": "K5b", "d": d, "rows": rows, "num_warps": warps,
                       **_times(torch, lambda: layernorm._ln_bwd_launch(
                           x, scale, mu, rstd, dy, rows, warps))}
                rec["device_gb_s"] = moved / rec["device_ms"] / 1e6
                out.append(rec)
                print(json.dumps(rec), flush=True)
        ws, wb = scale.to(torch.bfloat16), bias.to(torch.bfloat16)
        _, lmu, lrstd = torch.ops.aten.native_layer_norm(x, [d], ws, wb, 1e-6)
        rec = {"kernel": "aten native_layer_norm_backward", "d": d,
               **_times(torch, lambda: torch.ops.aten.native_layer_norm_backward(
                   dy, x, [d], lmu, lrstd, ws, wb, [True, True, True]))}
        out.append(rec)
        print(json.dumps(rec), flush=True)
    return out


# (N, K) of the main path's forward products at B*N = 25216 rows: K1's
# qkv and proj, K2's fc1 and fc2 (teacher, D=384); K3a's qkv and proj,
# K4a/K11a's fc1 and fc2 (student, D=192)
GEMM_SHAPES = ((1152, 384), (384, 384), (1536, 384), (384, 1536),
               (576, 192), (192, 192), (768, 192), (192, 768))


def gemm_sweep(torch, device, m: int = 25216) -> list:
    from basd_tpu_torch.kernels import block_mlp

    out = []
    g = torch.Generator(device=device).manual_seed(1)
    for n, k in GEMM_SHAPES:
        a = torch.randn((m, k), generator=g, device=device).to(torch.bfloat16)
        w = (torch.randn((n, k), generator=g, device=device) * k ** -0.5).to(
            torch.bfloat16)
        bias = 0.1 * torch.randn(n, generator=g, device=device)
        flops = 2 * m * n * k
        for tile_n, name in ((0, "wmma"), (64, "sm90 64"), (128, "sm90 128")):
            rec = {"kernel": f"gemm_nk {name}", "m": m, "n": n, "k": k,
                   **_times(torch, lambda: block_mlp.gemm_nk(a, w, bias, tile_n))}
            rec["device_tflop_s"] = flops / rec["device_ms"] / 1e9
            out.append(rec)
            print(json.dumps(rec), flush=True)
        rec = {"kernel": "F.linear", "m": m, "n": n, "k": k,
               **_times(torch, lambda: torch.nn.functional.linear(a, w))}
        rec["device_tflop_s"] = flops / rec["device_ms"] / 1e9
        out.append(rec)
        print(json.dumps(rec), flush=True)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=None, help="JSON file for the records")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("tune: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    device = torch.device("cuda")
    records = ln_bwd_sweep(torch, device) + gemm_sweep(torch, device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": smi, "records": records}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
