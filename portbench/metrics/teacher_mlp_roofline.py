"""K2g's share of its roofline in the profiled steps: the least time of the
launches its counter saw (``counts/launches_swiglu_mlp.py``: operations
over the bf16 peak or bytes over bandwidth, the larger) over the device
time of the kernels that ``counts/kernel_names_swiglu_mlp.txt`` names, in
percent. None where none of them ran (a GELU teacher, or a program
without K2g)."""

import re

from portbench.counts import launches_swiglu_mlp

NAMES = "kernel_names_swiglu_mlp.txt"


def kernel_names(bench_dir) -> set:
    """The names of ``NAMES``; ``#`` starts a comment."""
    text = (bench_dir / "counts" / NAMES).read_text()
    return {w for line in text.splitlines()
            for w in line.split("#", 1)[0].split()}


def read(ctx):
    prof = ctx["profile"]
    names = kernel_names(ctx["bench_dir"])
    ns = sum(end - start for start, end, name, _ in prof["trace"].device
             if names & set(re.findall(r"[A-Za-z_][A-Za-z0-9_]*", name)))
    counter = launches_swiglu_mlp.COUNTER
    launches = prof["launches"].get(counter, 0)
    if not ns or not launches:
        return None
    bound_s, _ = ctx["counts"].kernel_bound_seconds(ctx["shape"],
                                                    {counter: launches})
    return 100.0 * bound_s / (ns / 1e9)
