"""Device-time sweeps behind the tuned constants of the port's kernels.

    python -m basd_tpu_torch.tune [--out FILE] [--only SWEEP ...]

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
3. The backward products (``block_mlp.gemm_bwd``) at every (M, N, K,
   layout) of the main path's K3b, K4b and K11b: the WMMA tile, the sm90
   GEMM at tile widths 64 and 128 and, for the split-K weight gradients,
   at the split counts that aim for 132, 198, 264 and 396 CTAs
   (``gemm.split_k_chunk``'s target); ``torch.matmul`` on the same views
   as a yardstick (never called by the port).
4. K5a at the student's (128, 197, 192) and the teacher's (128, 197, 384):
   the Triton forward the CUDA kernel replaced (kept here only to be
   timed), the CUDA kernel at 2-8 chunks a lane (``LN_CHUNKS``), and
   ``torch.nn.functional.layer_norm``.

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


# The main path's backward products at B*N = 25216 rows, D=192, F=768:
# (name, epilogue, M, N, K); 'partial' is the weight gradient A^T B with
# A (K, M)
BWD_SHAPES = (
    ("K3b dattn", "f32", 25216, 192, 192),
    ("K3b dW_proj", "partial", 192, 192, 25216),
    ("K3b dW_qkv", "partial", 576, 192, 25216),
    ("K3b dxn", "f32", 25216, 192, 576),
    ("K4b/K11b dW2", "partial", 192, 768, 25216),
    ("K4b/K11b dpre (GELU gradient)", "dgelu", 25216, 768, 192),
    ("K4b/K11b dW1", "partial", 768, 192, 25216),
    ("K4b dxn", "f32", 25216, 192, 768),
    ("K11b dx", "round", 25216, 192, 768),
)


def bwd_gemm_sweep(torch, device) -> list:
    from basd_tpu_torch.kernels import block_mlp, gemm

    out = []
    g = torch.Generator(device=device).manual_seed(2)
    bf = torch.bfloat16
    for name, epi, m, n, k in BWD_SHAPES:
        a = torch.randn((k, m) if epi == "partial" else (m, k), generator=g,
                        device=device).to(bf)
        b = (torch.randn((k, n), generator=g, device=device) * k ** -0.5).to(bf)
        aux = (torch.randn((m, n), generator=g, device=device).to(bf)
               if epi == "dgelu" else None)
        flops = 2 * m * n * k
        configs = [(0, -1), (64, -1), (128, -1)]
        if epi == "partial":
            configs += sorted({(64, gemm.split_k_chunk(k, m, n, target))
                               for target in (132, 198, 264, 396)})
        for tile_n, k_chunk in configs:
            rec = {"kernel": f"gemm_bwd {epi}", "product": name, "m": m,
                   "n": n, "k": k, "tile_n": tile_n, "k_chunk": k_chunk,
                   "splits": -(-k // (gemm.split_k_chunk(k, m, n)
                                      if k_chunk < 0 else k_chunk))
                   if epi == "partial" else 1,
                   **_times(torch, lambda: block_mlp.gemm_bwd(
                       a, b, epi, aux, tile_n, k_chunk))}
            rec["device_tflop_s"] = flops / rec["device_ms"] / 1e9
            out.append(rec)
            print(json.dumps(rec), flush=True)
        at = a.t() if epi == "partial" else a
        rec = {"kernel": "torch.matmul", "product": name, "m": m, "n": n,
               "k": k, **_times(torch, lambda: torch.matmul(at, b))}
        rec["device_tflop_s"] = flops / rec["device_ms"] / 1e9
        out.append(rec)
        print(json.dumps(rec), flush=True)
    return out


def _triton_ln_fwd():
    """The Triton LayerNorm forward that K5a's CUDA kernel replaced (16 rows
    a program, the row padded to a power of two), for timing only."""
    import triton
    import triton.language as tl

    @triton.jit
    def ln_fwd_kernel(x_ptr, w_ptr, b_ptr, o_ptr, mu_ptr, rstd_ptr, m, d, eps,
                      ROWS: tl.constexpr, BLOCK_D: tl.constexpr):
        pid = tl.program_id(0)
        rows = pid * ROWS + tl.arange(0, ROWS)
        cols = tl.arange(0, BLOCK_D)
        rmask = rows < m
        cmask = cols < d
        m2 = rmask[:, None] & cmask[None, :]
        offs = rows[:, None] * d + cols[None, :]
        x = tl.load(x_ptr + offs, mask=m2, other=0.0).to(tl.float32)
        mu = tl.sum(x, axis=1) / d
        xc = tl.where(m2, x - mu[:, None], 0.0)
        var = tl.sum(xc * xc, axis=1) / d
        rstd = tl.rsqrt(var + eps)
        w = tl.load(w_ptr + cols, mask=cmask, other=0.0)
        b = tl.load(b_ptr + cols, mask=cmask, other=0.0)
        y = xc * rstd[:, None] * w[None, :] + b[None, :]
        tl.store(o_ptr + offs, y.to(o_ptr.dtype.element_ty), mask=m2)
        tl.store(mu_ptr + rows, mu, mask=rmask)
        tl.store(rstd_ptr + rows, rstd, mask=rmask)

    def run(x, scale, bias, eps=1e-6):
        b, n, d = x.shape
        out = x.new_empty(x.shape)
        mu = x.new_empty((b, n), dtype=scale.dtype)
        rstd = x.new_empty((b, n), dtype=scale.dtype)
        ln_fwd_kernel[(-(-b * n // 16),)](x, scale, bias, out, mu, rstd,
                                          b * n, d, eps, ROWS=16,
                                          BLOCK_D=1 << (d - 1).bit_length())
        return out, mu, rstd

    return run


def ln_fwd_sweep(torch, device) -> list:
    from basd_tpu_torch.kernels import layernorm

    out = []
    triton_fwd = _triton_ln_fwd()
    g = torch.Generator(device=device).manual_seed(3)
    for d in (192, 384):
        x = torch.randn((128, 197, d), generator=g, device=device).to(torch.bfloat16)
        scale = 1.0 + 0.1 * torch.randn(d, generator=g, device=device)
        bias = 0.1 * torch.randn(d, generator=g, device=device)
        ws, wb = scale.to(torch.bfloat16), bias.to(torch.bfloat16)
        moved = 2 * x.numel() * 2 + 2 * 128 * 197 * 4 + 2 * d * 4
        ref = layernorm.layernorm_plain_fwd(x, scale, bias)[0]
        cases = [("K5a Triton (replaced)", lambda: triton_fwd(x, scale, bias)),
                 ("K5a CUDA", lambda: layernorm.layernorm_fwd(x, scale, bias))]
        cases += [(f"K5a CUDA {c} chunks a lane",
                   (lambda c=c: layernorm._ln_fwd_launch(x, scale, bias, 1e-6, c)))
                  for c in (2, 3, 4, 6, 8)]
        cases.append(("F.layer_norm", lambda: torch.nn.functional.layer_norm(
            x, (d,), ws, wb, 1e-6)))
        for name, fn in cases:
            if name != "F.layer_norm":
                err = (fn()[0].float() - ref.float()).abs().max().item()
                if not err <= 2 ** -5 * max(ref.float().abs().max().item(), 1.0):
                    raise AssertionError(f"{name} at D={d}: max_abs_err {err}")
            rec = {"kernel": name, "d": d, **_times(torch, fn)}
            rec["device_gb_s"] = moved / rec["device_ms"] / 1e6
            out.append(rec)
            print(json.dumps(rec), flush=True)
    return out


SWEEPS = {"ln_bwd": ln_bwd_sweep, "gemm": gemm_sweep, "bwd_gemm": bwd_gemm_sweep,
          "ln_fwd": ln_fwd_sweep}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=None, help="JSON file for the records")
    parser.add_argument("--only", nargs="+", choices=sorted(SWEEPS),
                        default=list(SWEEPS), help="the sweeps to run")
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
    records = [rec for name in args.only for rec in SWEEPS[name](torch, device)]
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": smi, "records": records}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
