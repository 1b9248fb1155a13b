"""The port's hand-written kernels' share of their roofline in the profiled
steps: the least time of the launches their counters saw (each launch's
operations over peak or bytes over bandwidth, the larger, from the cell's
shapes by ``counts.kernel_launches`` and ``counts/launches_*.py``) over
the device time of the kernels whose names the port's sources give
(``counts/kernel_names*.txt``), in percent. Device kernels of neither the
port nor a library are named on standard error, as are counters the
arithmetic does not know."""

import re

# marks of the kernels of PyTorch and of the CUDA libraries it calls
LIBRARY = ("at::", "at_cuda", "cutlass", "cublas", "cusolver", "syevj",
           "syevbj", "sm90_xmma", "sm80_xmma", "nvjet", "gemv", "gemm",
           "Memcpy", "Memset", "cudnn", "xmma", "ampere", "magma", "triton_",
           "elementwise", "reduce_kernel", "splitK", "Kernel2", "cub::",
           "softmax_warp", "batch_", "pegasus", "_rotate_", "lascl", "offA",
           "colperm", "vectorized_", "CatArrayBatched", "indexSelect",
           "scatter_gather", "distribution_", "copy_info_kernel")


def port_kernel_names(bench_dir):
    """The kernel names of ``counts/kernel_names*.txt``; ``#`` starts a
    comment."""
    names = set()
    for path in sorted((bench_dir / "counts").glob("kernel_names*.txt")):
        for line in path.read_text().splitlines():
            names.update(line.split("#", 1)[0].split())
    return names


def read(ctx):
    prof = ctx["profile"]
    names = port_kernel_names(ctx["bench_dir"])
    port_ns, unknown = 0, set()
    for start, end, name, _ in prof["trace"].device:
        if names & set(re.findall(r"[A-Za-z_][A-Za-z0-9_]*", name)):
            port_ns += end - start
        elif not any(m in name for m in LIBRARY):
            unknown.add(name[:120])
    bound_s, unknown_counters = ctx["counts"].kernel_bound_seconds(
        ctx["shape"], prof["launches"])
    for name in sorted(unknown):
        ctx["log"](f"kernels_roofline: device kernel of no known source: "
                   f"{name}")
    for name in unknown_counters:
        ctx["log"](f"kernels_roofline: no arithmetic for {name}; left out")
    if not port_ns:
        return None
    return 100.0 * bound_s / (port_ns / 1e9)
