"""The comparison that decides ``correct``: the program's first three train
steps against the reference's, by three numbers, each with its limit.

- ``loss_gap``: the largest gap of a step's loss, over the reference's.
- ``grad_gap``: by the worst leaf, the gap between the program's and the
  reference's norm of the first gradient (the program's as its optimizer
  got it: sqrt(sum v / (1 - b2)) of the second moment after one step), over
  the reference's norm of that leaf or of the median leaf, the larger.
- ``change_gap``: the same for the norm of each leaf's change from the
  initial weights to the point the fourth step evaluates at,
  y = b1 x + (1 - b1) z. What Adam moves by round-off alone is left out,
  by a rule on the reference's first gradient: a leaf whose norm is under
  a thousandth of the median leaf's, and within a leaf each element under
  a thousandth of the leaf's root-mean-square element (a key's bias under
  softmax, whose gradient is nought but for rounding, inside the qkv
  bias).

The worst leaf swings from seed to seed with the noise of small leaves
(the CLS token, the log-temperatures, LayerNorm scales and biases), so
two steadier numbers stand beside them, the ones the control fails:

- ``grad_median_gap`` and ``change_median_gap``: the median leaf's gap,
  each leaf's gap measured as above.

``loss1_gap``, the first step's loss gap, is read but not compared: the
control reads no higher than the program there (PERF.md).

A number that is not finite fails its limit."""

from __future__ import annotations

import math
import statistics

NUMBERS = ("loss_gap", "grad_gap", "grad_median_gap", "change_gap",
           "change_median_gap")
IDLE = 1e-3


def _gaps(prog: dict, ref: dict, keys) -> dict:
    """Each leaf's gap over the reference's norm of that leaf or of the
    median leaf, the larger."""
    keys = list(keys)
    median = statistics.median(ref[k] for k in keys)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30)
            for k in keys}


def _worst_and_median(gaps: dict) -> tuple:
    """(the worst leaf's gap, that leaf, the median leaf's gap); a gap
    that is not finite is infinite."""
    if not all(math.isfinite(v) for v in gaps.values()):
        leaf = next(k for k, v in gaps.items() if not math.isfinite(v))
        return math.inf, leaf, math.inf
    leaf = max(gaps, key=gaps.get)
    return gaps[leaf], leaf, statistics.median(gaps.values())


def _kept_change_norms(prog: dict, ref: dict, keys) -> tuple:
    """Each kept leaf's change norm on both sides over the elements the
    reference's first gradient does not leave out, and the count left
    out."""
    p_norms, r_norms, idle = {}, {}, 0
    for k in keys:
        g = ref["grads"][k].double()
        rms = g.norm() / max(g.numel(), 1) ** 0.5
        keep = g.abs() >= IDLE * rms
        idle += int((~keep).sum())
        p_norms[k] = float(prog["changes"][k].double()[keep].norm())
        r_norms[k] = float(ref["changes"][k].double()[keep].norm())
    return p_norms, r_norms, idle


def readings(prog: dict, ref: dict) -> dict:
    """The three numbers and, for each norm, the leaf that sets it."""
    losses = [abs(p - r) / max(abs(r), 1e-30)
              for p, r in zip(prog["losses"], ref["losses"])]
    if not all(math.isfinite(p) for p in prog["losses"]):
        losses = [math.inf] * len(losses)
    g_ref = ref["grad_norms"]
    grad_gap, grad_leaf, grad_median = _worst_and_median(
        _gaps(prog["grad_norms"], g_ref, g_ref))
    median_g = statistics.median(g_ref.values())
    kept = [k for k in g_ref if g_ref[k] >= IDLE * median_g]
    p_norms, r_norms, idle = _kept_change_norms(prog, ref, kept)
    change_gap, change_leaf, change_median = _worst_and_median(
        _gaps(p_norms, r_norms, kept))
    return {"loss_gap": max(losses), "loss1_gap": losses[0],
            "grad_gap": grad_gap, "grad_median_gap": grad_median,
            "change_gap": change_gap, "change_median_gap": change_median,
            "grad_leaf": grad_leaf, "change_leaf": change_leaf,
            "left_out": sorted(set(g_ref) - set(kept)),
            "idle_elements": idle}


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}})."""
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in NUMBERS}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
