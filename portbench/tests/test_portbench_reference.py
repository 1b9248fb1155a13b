"""The plain reference against the port's plain CPU path at tiny widths,
in float32, with the polar iteration rounded as the configuration rounds
it (bfloat16) on both sides: the first step agrees to rounding; the next
two drift only as far as Adam's first steps amplify rounding (every
coordinate moves by about the learning rate whatever its gradient). The
step-1 loss is held to 1e-4: under the jacobi backend both sides take
the principal-angle eigenvalues from 6 Jacobi sweeps (the configuration's
count), in their own orders of rotation."""

import functools
import time

import pytest
import torch

from portbench import bench
from portbench.reference.arith import Arith
from portbench.reference.step import reference_steps
from portbench.tests.tiny import tiny_cell


def matched_reference(monkeypatch):
    monkeypatch.setattr(bench, "reference_steps", functools.partial(
        reference_steps, arith=Arith("f32", polar_dtype=torch.bfloat16)))


@pytest.mark.parametrize("config", ["dinov2_b14-s320_gram",
                                    "deit_s-ti_jacobi"])
def test_reference_holds_the_port(config, monkeypatch):
    torch.set_num_threads(2)
    matched_reference(monkeypatch)
    seen = {}
    real = bench.check.readings

    def spy(prog, ref):
        seen["prog"], seen["ref"] = prog, ref
        return real(prog, ref)

    monkeypatch.setattr(bench.check, "readings", spy)
    cell = tiny_cell(config)
    result = bench.run(cell, 2 ** 33 + 1, 0.01, False, time.perf_counter(),
                       device="cpu")
    prog, ref = seen["prog"], seen["ref"]
    assert prog["losses"][0] == pytest.approx(ref["losses"][0], rel=1e-4)
    checks = {k: v["value"] for k, v in result["checks"].items()}
    assert checks["grad_gap"] < 5e-3
    assert checks["loss_gap"] < 2e-2 and checks["change_gap"] < 5e-2
    assert set(prog["changes"]) == set(ref["changes"])


def test_reference_runs_alone_on_the_same_inputs():
    cell = tiny_cell()
    a = reference_steps(cell.config, cell.traffic, 3, "cpu", steps=2)
    b = reference_steps(cell.config, cell.traffic, 3, "cpu", steps=2)
    assert a["losses"] == b["losses"]
    c = reference_steps(cell.config, cell.traffic, 4, "cpu", steps=2)
    assert a["losses"] != c["losses"]
