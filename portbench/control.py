"""The readings that a cell's limits are set from, at the cell's own size
on the card. The benchmark's runs never run this.

    python portbench/control.py --workload <cell> --seeds 11,12,13 \\
        --kinds program,control,tf32,half,grad,frozen,lnbias \\
        [--program-seeds 14,15]

For each seed, the reference in float32, and against it, by the check's
numbers (``check.readings``), each kind asked for: ``program``, the port's
trainer built and driven through its first steps as a benchmark run does;
``control``, the reference in the program's place in the control's
arithmetic (``reference.arith``: fp8 operands where the configuration
computes in bfloat16, TF32 where it computes in float32); ``tf32``, the
same with the loss's float32 products alone lowered; ``half``, ``grad``,
``frozen``, ``lnbias``, the reference in the program's place with that
fault planted (``reference.step``). ``--program-seeds`` reads the program
alone on more seeds. Prints one JSON line a reading on standard error,
with each leaf's first-gradient gap over its own norm beside the check's
numbers, and, last on standard output, the largest reading of each
number for the program and the smallest for every other kind."""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def program_steps(cell, seed: int, device) -> dict:
    """The program's first steps, as ``bench.run`` drives them."""
    import torch

    from portbench import bench
    from portbench.inputs import make_inputs

    inp = make_inputs(cell.config, cell.traffic, seed, device)
    with tempfile.TemporaryDirectory(prefix="portbench-") as out_dir:
        trainer = bench.build_trainer(cell, inp, device, out_dir)
        prog = bench.first_steps(trainer, inp, int(cell.traffic["pool"]))
        del trainer, inp
    gc.collect()
    torch.cuda.empty_cache()
    return prog


def own_norm_gaps(other: dict, ref: dict) -> dict:
    """The worst first-gradient gap over the leaf's own norm, among the
    leaves the change keeps; the 'lnbias' fault's leaf: its gap so
    measured and its reference norm over the median leaf's; and each leaf
    whose reference norm is under a tenth of the median leaf's, with that
    share."""
    from portbench import check
    from portbench.reference.step import LN_FAULT_LEAF

    g_ref = ref["grad_norms"]
    median = statistics.median(g_ref.values())
    gaps = {k: abs(other["grad_norms"][k] - r) / r
            for k, r in g_ref.items() if r >= check.IDLE * median}
    worst = max(gaps, key=gaps.get)
    return {"grad_own_gap": gaps[worst], "grad_own_leaf": worst,
            "ln_leaf_own_gap": gaps.get(LN_FAULT_LEAF),
            "ln_leaf_over_median": g_ref.get(LN_FAULT_LEAF, 0.0) / median,
            "small_leaves": {k: r / median for k, r in g_ref.items()
                             if r < 0.1 * median}}


def readings(cell, seed: int, kinds: list, device, log) -> list:
    from portbench import check
    from portbench.reference.step import reference_steps

    ref = reference_steps(cell.config, cell.traffic, seed, device)
    out = []
    for kind in kinds:
        t0 = time.perf_counter()
        if kind == "program":
            other = program_steps(cell, seed, device)
        elif kind in ("control", "tf32"):
            other = reference_steps(cell.config, cell.traffic, seed, device,
                                    arith=kind)
        else:
            other = reference_steps(cell.config, cell.traffic, seed, device,
                                    fault=kind)
        nums = check.readings(other, ref)
        nums.pop("left_out")
        nums.update(own_norm_gaps(other, ref))
        out.append({"cell": cell.name, "seed": seed, "kind": kind, **nums,
                    "seconds": time.perf_counter() - t0})
        log(json.dumps(out[-1]))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--kinds", default="control")
    p.add_argument("--program-seeds", default="")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import check
    from portbench.bench import log
    from portbench.cells import load_cell

    if not torch.cuda.is_available():
        log("no CUDA device")
        return 2
    cell = load_cell(args.workload)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        rows += readings(cell, seed, args.kinds.split(","), "cuda", log)
    for seed in (int(s) for s in args.program_seeds.split(",") if s):
        rows += readings(cell, seed, ["program"], "cuda", log)
    summary = {}
    for r in rows:
        for k in check.NUMBERS + ("loss1_gap",):
            key = f"{r['kind']}.{k}"
            pick = max if r["kind"] == "program" else min
            summary[key] = pick(summary.get(key, r[k]), r[k])
    print(json.dumps({"cell": cell.name, "seeds": len(rows),
                      "program_max_others_min": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
