"""The readers of the program tracer's spans and counters
(``basd_tpu_torch/utils/trace.py``) on hand-built contexts, and on the
card a profiled run with the tracer on: one ``basd.eigh`` annotation in
the trace for each ``eigh`` span the tracer recorded."""

import dataclasses
import importlib
import tempfile

import pytest

from portbench.cells import load_cell
from portbench.trace import Trace

SPAN_READERS = {"views_ms": "views", "teacher_ms": "teacher",
                "student_loss_ms": "loss_and_grads", "update_ms": "update",
                "student_fwd_ms": "student_forward", "selector_ms": "selector",
                "selector_eigh_ms": "eigh", "procrustes_ms": "procrustes",
                "backward_ms": "backward"}


def reader(name):
    return importlib.import_module(f"portbench.metrics.{name}").read


def program(spans: dict, counters: dict) -> dict:
    """A ``trace.summary()`` of the given spans' device ms."""
    return {"spans": {k: {"parents": ["x"], "calls": 4, "steps": 4,
                          "device_ms": ms, "host_ms": 1.0,
                          "self_device_ms": ms, "self_host_ms": 1.0}
                      for k, ms in spans.items()},
            "counters": counters}


@pytest.mark.parametrize("metric", sorted(SPAN_READERS))
def test_span_readers(metric):
    span = SPAN_READERS[metric]
    ctx = {"steps": 4, "program": program({span: 10.0, "other": 99.0}, {})}
    assert reader(metric)(ctx) == 2.5
    # a run without the program tracer, or whose tracer ran no such span
    assert reader(metric)({"steps": 4}) is None
    assert reader(metric)({"steps": 4, "program": program({}, {})}) is None


def test_eigh_matrices():
    # every route's matrices, and no other counter
    read = reader("eigh_matrices")
    ctx = {"steps": 4, "program": program({}, {
        "eigh.matrices.converged": 64, "eigh.matrices.jacobi": 192,
        "eigh.matrices.xla": 0, "eigh.calls.converged": 4,
        "eigh.calls.jacobi": 4, "grad_reduce.calls": 8})}
    assert read(ctx) == 64
    assert read({"steps": 4, "program": program({}, {})}) == 0
    assert read({"steps": 4}) is None


def test_eigh_idle_ms_on_a_synthetic_trace():
    # device busy [0, 10], [20, 30], [25, 40], [50, 60], [70, 80] ns:
    # gaps (10, 20), (40, 50), (60, 70)
    tr = Trace(device=[(0, 10, "k", 1), (20, 30, "k", 2), (25, 40, "k", 3),
                       (50, 60, "k", 4), (70, 80, "k", 5)],
               annotations=[(5, 22, "basd.eigh"), (45, 75, "basd.eigh"),
                            (0, 80, "student_loss"), (12, 18, "basd.step")])
    ctx = {"profile": {"trace": tr, "steps": 2}}
    # (10, 20) whole: 10; (40, 50) from 45: 5; (60, 70) whole: 10
    assert reader("eigh_idle_ms")(ctx) == pytest.approx(25 / 1e6 / 2)
    idle = importlib.import_module("portbench.metrics.eigh_idle_ms")
    _, merged = tr.busy()
    assert idle.idle_within(merged, [(0, 80)]) == 30  # every gap
    assert idle.idle_within(merged, [(30, 40), (81, 90)]) == 0
    no_marks = Trace(device=tr.device, annotations=[(0, 80, "student_loss")])
    assert reader("eigh_idle_ms")({"profile": {"trace": no_marks,
                                               "steps": 2}}) is None


@pytest.mark.card
def test_profile_holds_one_annotation_per_eigh_span(card):
    from basd_tpu_torch.utils import trace

    from portbench import bench
    from portbench.inputs import make_inputs

    cell = load_cell("dinov2_b14-s320_gram.b256")
    cell = dataclasses.replace(cell, traffic={**cell.traffic, "batch": 16})
    inp = make_inputs(cell.config, cell.traffic, 2 ** 31 + 41, card)
    with tempfile.TemporaryDirectory() as out_dir:
        trainer = bench.build_trainer(cell, inp, card, out_dir)
        trainer.step(inp["images"][0], inp["labels"][0])
        trace.reset()
        trace.enable()
        try:
            prof = bench.profiled_window(trainer, inp,
                                         int(cell.traffic["pool"]), 1)
            summary = trace.summary()
        finally:
            trace.disable()
    marks = [a for a in prof["trace"].annotations if a[2] == "basd.eigh"]
    assert summary["spans"]["eigh"]["calls"] == len(marks) == 2 * prof["steps"]
    ctx = {"program": summary, "steps": prof["steps"], "profile": prof}
    assert reader("eigh_matrices")(ctx) == 64
    assert 0 <= reader("eigh_idle_ms")(ctx) < 1e3
    for metric in SPAN_READERS:
        assert reader(metric)(ctx) > 0
    spans = summary["spans"]
    children = sum(spans[k]["device_ms"] for k in (
        "student_forward", "basd_loss", "backward"))
    assert spans["loss_and_grads"]["self_device_ms"] == pytest.approx(
        spans["loss_and_grads"]["device_ms"] - children)
