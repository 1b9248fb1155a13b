"""The port's benchmark: one run of one cell.

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cell's NVIDIA cards.
Prints, as its last line of standard output, one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number the check compared with
its limit). Exits with another code than 0, printing no result, where
there is no card or fewer than the cell asks for, and where a module of
JAX or of the JAX package is loaded. The program's compile caches stay in
fixed directories of the checkout (``build/``)."""

from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def cache_dirs(root: Path) -> None:
    """Triton's cache and home under the checkout's ``build/portbench``;
    the port builds its CUDA library into ``build/basd_tpu_torch`` itself.
    ``transformers``, should anything load it, is told to leave JAX
    alone."""
    build = root / "build" / "portbench"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton" / "cache")
    os.environ["TRITON_HOME"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cache_dirs(ROOT)
    sys.path.insert(0, str(ROOT))

    import torch

    from portbench.bench import forbidden_modules, log, run
    from portbench.cells import load_cell

    cell = load_cell(args.workload)
    if not torch.cuda.is_available():
        log("no CUDA device: the benchmark measures the card and does not "
            "fall back to the CPU")
        return 2
    if torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} asks for {cell.chips} cards; "
            f"{torch.cuda.device_count()} present")
        return 2
    torch.cuda.set_device(0)
    result = run(cell, args.seed, args.seconds, bool(args.trace), START)
    found = forbidden_modules()
    if found:
        log(f"loaded modules of JAX or the JAX package: {found}")
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
