"""K7 for r > 192 on one CUDA GPU: the batched variant checked and timed,
and the exchange of the cluster design it was weighed against.

    python3 scripts/k7_probe.py [--out FILE]

1. ``chip_smoke.k7_check`` on the batched variant (within 3e-2 of the
   plain version and within ``k7_bounds``, both one-step-short controls
   failing, polar defect <= 5e-2, two launches bit-equal) at ragged row
   counts ((3, 200, 256), (2, 264, 384), (3, 256, 256): boxes zero-filled
   at each matrix's edges, warpgroups past r idle) and at (8, 384, 768),
   (512, 320, 768) and (512, 512, 1024).
2. At (512, 320, 768) and (512, 512, 1024), CUDA-event times
   (``chip_smoke.time_ms``) of the batched variant and the plain version;
   the bound (``chip_smoke.bound``) from the operations the function needs
   (``ns_polar.polar_flops``).
3. The thread-block-cluster design (``scripts/k7_cluster_probe.cu``,
   built here by nvcc into ``build/k7_probe/``, not part of the port): S
   CTAs a matrix of r = 64 S rows, at S = 5 (r = 320) and S = 8 (r =
   512), 512 matrices. First its exchange alone (each CTA gathering the
   other S - 1 panels of G over distributed shared memory once for each
   of the 5 quintic steps; the clusters resident at once), then the whole
   kernel (X chunks by TMA multicast, G panels exchanged, the products
   and the rounding points of the batched variant): held to
   ``chip_smoke.k7_bounds`` and the two-launch bit equality, and timed.
4. The batched variant's device time by kernel (``torch.profiler`` over
   3 calls): the prescale and each product, by epilogue (``NsPhase``: 0
   G = X X^T, 1 H, 2 the quintic X update, 3 the cubic one).
5. The rule, stated before the first reading: the cluster design does the
   same products and the exchange besides, so it takes at least
   max(exchange, products at the bf16 peak); it can beat the batched
   variant only where that floor lies below the batched variant's time.
   Where it does, the whole kernel's time decides.

Prints one JSON object a line, the card's name and power limit, and
writes them to ``--out`` too.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PROBE_SRC = REPO / "scripts" / "k7_cluster_probe.cu"
PROBE_DIR = REPO / "build" / "k7_probe"
# matrices of the Procrustes batch (P * B at B = 128) and quintic steps
BATCH = 512
QUINTIC_STEPS = 5
CHECK_SHAPES = ((3, 200, 256), (2, 264, 384), (3, 256, 256), (8, 384, 768),
                (512, 320, 768), (512, 512, 1024))
TIMED_SHAPES = ((512, 320, 768, 5), (512, 512, 1024, 8))


def build_probe() -> ctypes.CDLL:
    """The cluster exchange probe, built with the port's nvcc and flags."""
    sys.path.insert(0, str(REPO))
    from basd_tpu_torch.kernels import _build

    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    lib = PROBE_DIR / "libk7_cluster_probe.so"
    subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-Xptxas=-v", "-I", str(_build.CSRC_DIR), "-o", str(lib),
                    str(PROBE_SRC)], check=True)
    dll = ctypes.CDLL(str(lib))
    dll.k7_cluster_exchange.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    dll.k7_cluster_occupancy.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    dll.k7_cluster_polar.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                                     + [ctypes.c_void_p])
    return dll


def kernel_times(torch, fn, calls: int = 3) -> dict:
    """Device ms a call of each kernel that ``fn`` launches, and its
    launches a call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {a.key[:90]: {"ms": a.self_device_time_total / 1e3 / calls,
                         "launches": a.count / calls}
            for a in prof.key_averages() if a.self_device_time_total > 0}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(REPO))

    import torch

    if not torch.cuda.is_available():
        print("k7_probe: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from basd_tpu_torch.kernels import ns_polar
    from basd_tpu_torch.ops.linalg import set_full_f32_precision

    set_full_f32_precision()
    device = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    lines = []

    def emit(rec):
        lines.append(json.dumps(rec))
        print(lines[-1], flush=True)

    g = torch.Generator(device=device).manual_seed(31)

    def rn(*shape):
        return torch.randn(*shape, generator=g, device=device)

    mats = {}
    for nb, r, c in CHECK_SHAPES:
        x = cs.polar_batch(torch, rn, nb, r, c, reduced=True)
        rec = cs.k7_check(torch, ns_polar, x, "batched")
        emit({"check": [nb, r, c], **rec})
        if nb == BATCH:
            mats[(r, c)] = x
        torch.cuda.synchronize()

    dll = build_probe()
    sink = torch.zeros(1, dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream().cuda_stream
    for nb, r, c, s in TIMED_SHAPES:
        x = mats[(r, c)]
        out = torch.empty((nb, r, c), dtype=torch.bfloat16, device=device)
        flops = ns_polar.polar_flops(nb, r, c)
        bound_ms, bound_by = cs.bound(cs.nbytes(x, out), flops, cs.PEAK_BF16)
        times = {"batched_ms": cs.time_ms(
            torch, lambda: ns_polar.ns_polar_hybrid(x))}
        times["plain_ms"] = cs.time_ms(torch, lambda: ns_polar.ns_polar_plain(x),
                                       reps=3)

        def exchange():
            rc = dll.k7_cluster_exchange(nb, s, QUINTIC_STEPS, sink.data_ptr(),
                                         stream)
            if rc:
                raise RuntimeError(f"k7_cluster_exchange: CUDA error {rc}")

        emit({"shape": [nb, r, c], "kernels": kernel_times(
            torch, lambda: ns_polar.ns_polar_hybrid(x))})
        clusters = ctypes.c_int(0)
        rc = dll.k7_cluster_occupancy(s, ctypes.byref(clusters))
        exchange_ms = cs.time_ms(torch, exchange)
        floor_ms = max(exchange_ms, flops / cs.PEAK_BF16 * 1e3)
        ws = torch.empty(nb * (2 * r * c + (64 * s) ** 2), dtype=torch.bfloat16,
                         device=device)

        def cluster():
            o = torch.empty((nb, r, c), dtype=torch.bfloat16, device=device)
            rc = dll.k7_cluster_polar(x.data_ptr(), o.data_ptr(), ws.data_ptr(),
                                      nb, r, c, stream)
            if rc:
                raise RuntimeError(f"k7_cluster_polar: CUDA error {rc}")
            return o

        co = cluster()
        torch.cuda.synchronize()
        c_bounds = cs.k7_bounds(torch, co, ns_polar.ns_polar_plain(x))
        c_equal = torch.equal(co, cluster())
        cluster_ms = cs.time_ms(torch, cluster)
        emit({"shape": [nb, r, c], "bound_ms": bound_ms, "bound_by": bound_by,
              **times,
              "share_of_bound": bound_ms / times["batched_ms"],
              "cluster_s": s, "cluster_resident": clusters.value if rc == 0 else None,
              "cluster_exchange_ms": exchange_ms,
              "cluster_exchange_bytes_per_cta_step": (s - 1) * 64 * r * 2,
              "cluster_floor_ms": floor_ms,
              "cluster_can_win": floor_ms < times["batched_ms"],
              "cluster_ms": cluster_ms, "cluster_rel": c_bounds["rel"],
              "cluster_sv": c_bounds["sv"], "cluster_within_bounds": c_bounds["ok"],
              "cluster_two_launches_equal": c_equal,
              "faster": "cluster" if cluster_ms < times["batched_ms"] else "batched"})
        torch.cuda.synchronize()
    print(smi)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines + [smi]) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
