"""The port's tracer (``basd_tpu_torch/utils/trace.py``): nothing recorded
or entered while it is off; the span tree, step numbers, self times and
counters of a tiny trainer's steps on the gram and jacobi paths while it
is on; its folding of finished records; equal bits with it on and off; and
the ``trace`` record an epoch that ``run.trace`` writes. CPU only: the
spans carry no CUDA events here."""

from __future__ import annotations

import json
import time
import types

import numpy as np
import pytest
import torch

from basd_tpu_torch.utils import trace
from tests import torch_dp_worker as worker

STEP_TREE = {
    "step": [None],
    "views": ["step"],
    "teacher": ["step"],
    "teacher_mlp": ["teacher"],
    "loss_and_grads": ["step"],
    "update": ["step"],
    "student_forward": ["loss_and_grads"],
    "basd_loss": ["loss_and_grads"],
    "backward": ["loss_and_grads"],
    "selector": ["basd_loss"],
    "procrustes": ["basd_loss"],
    "eigh": ["selector"],
}


@pytest.fixture(autouse=True)
def tracer_off():
    """Every test starts and ends with the tracer off and empty."""
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def tiny_trainer(out_dir, *overrides):
    """``torch_dp_worker``'s tiny trainer (packed f32 teacher, f32 student
    with stochastic depth) with config overrides."""
    from basd_tpu_torch.config import compose, register_resolvers
    from basd_tpu_torch.models.registry import create_model, init_model
    from basd_tpu_torch.train import _CONFIG_DIR
    from basd_tpu_torch.training.trainer import Trainer

    register_resolvers()
    cfg = compose(_CONFIG_DIR, overrides=[
        "experiment=smoke_synthetic", "data.dataset=synthetic/tiny",
        f"run.output_dir={out_dir}", f"model.vit.img_size={worker.IMG}",
        f"model.vit.patch_size={worker.PATCH}",
        f"data.batch_size={worker.BATCH}",
        "basd.teacher_model_name=tiny_teacher", *overrides])
    teacher = create_model("tiny_teacher", img_size=worker.IMG,
                           arch_overrides=worker.T_ARCH,
                           importance_mode="cls", collect=True)
    init_model(teacher, 0)
    teacher.module.eval().requires_grad_(False)
    student = create_model("tiny_student", img_size=worker.IMG,
                           num_classes=worker.C, drop_path_rate=0.1,
                           arch_overrides=worker.S_ARCH)
    init_model(student, 1, fan_in_init=True)
    return Trainer(cfg, student_bundle=student, teacher_bundle=teacher,
                   device=torch.device("cpu"),
                   dataset_stats=((0.5,) * 3, (0.25,) * 3),
                   teacher_stats=(teacher.mean, teacher.std))


def batches(trainer, steps: int):
    r = worker.canvas(trainer)
    return [trainer.to_device(b) for b in worker.global_batches(r, steps)]


def test_off_records_and_enters_nothing(tmp_path, monkeypatch):
    trainer = tiny_trainer(tmp_path)
    (images, labels), = batches(trainer, 1)

    def no_event():
        raise AssertionError("an event made while the tracer is off")

    monkeypatch.setattr(trace, "_new_event", no_event)
    assert trace.span("step") is trace.span("selector")  # the shared no-op
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        trainer.step(images, labels)
    names = {e.name for e in prof.events()}
    assert "aten::_linalg_eigh" in names  # the profiler saw the step
    assert not [n for n in names if n.startswith(trace.PREFIX)]
    assert len(trace._pending) == 0
    assert trace.summary() == {"spans": {}, "counters": {}}


@pytest.mark.parametrize("backend", ["gram", "jacobi"])
def test_on_gives_the_step_tree_and_counts(tmp_path, backend):
    extra = (["basd.spectral_backend=jacobi", "basd.max_rank=16"]
             if backend == "jacobi" else [])
    trainer = tiny_trainer(tmp_path, *extra)
    data = batches(trainer, 2)
    trace.enable()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for images, labels in data:
            trainer.step(images, labels)
    s = trace.summary()
    spans = s["spans"]
    assert {k: v["parents"] for k, v in spans.items()} == STEP_TREE
    assert all(v["steps"] == 2 for v in spans.values())
    assert spans["step"]["calls"] == 2
    assert spans["eigh"]["calls"] == 4  # the stacked and the angles' a step
    marks = [e.name for e in prof.events()
             if e.name.startswith(trace.PREFIX)]
    assert sorted(set(marks)) == sorted(trace.PREFIX + k for k in STEP_TREE)
    assert marks.count("basd.eigh") == spans["eigh"]["calls"]
    for name in STEP_TREE:
        children = [k for k, p in STEP_TREE.items() if p == [name]]
        want = spans[name]["host_ms"] - sum(spans[c]["host_ms"]
                                            for c in children)
        assert spans[name]["self_host_ms"] == pytest.approx(want, abs=1e-9)
        assert spans[name]["device_ms"] == 0.0  # no CUDA events here
        assert spans[name]["host_ms"] >= spans[name]["self_host_ms"] >= 0
    L = trainer.teacher.cfg.depth
    P = trainer.loss_cfg.num_extraction_points
    steps = 2
    if backend == "gram":
        want = {"eigh.calls.xla": 2 * steps,
                "eigh.matrices.xla": (L + P + P * L) * steps}
    else:
        want = {"eigh.calls.xla": steps, "eigh.matrices.xla": (L + P) * steps,
                "eigh.calls.jacobi": steps,
                "eigh.matrices.jacobi": P * L * steps}
    # K6's route: the plain einsum on the CPU, one mix a step
    want["mix.calls.plain"] = steps
    # one teacher_mlp span a teacher block a step
    assert spans["teacher_mlp"]["calls"] == L * steps
    assert s["counters"] == want
    per = trace.per_step(s)
    assert per["steps"] == 2
    assert per["counters"]["eigh.matrices.xla"] == want[
        "eigh.matrices.xla"] / 2
    assert per["spans"]["eigh"]["calls"] == 2


@pytest.mark.parametrize("on", [True, False])
def test_swiglu_teacher_records_a_span_a_block_mlp(on):
    """A tiny SwiGLU teacher's forward: one ``teacher_mlp`` span a block,
    inside ``teacher``; nothing with the tracer off."""
    from basd_tpu_torch.models.registry import (
        create_model,
        init_model,
        teacher_extract,
    )

    bundle = create_model(
        "tiny_swiglu", img_size=32, importance_mode="cls", collect=True,
        arch_overrides=dict(embed_dim=64, depth=3, num_heads=2, patch_size=8,
                            mlp="swiglu", mlp_hidden=128))
    init_model(bundle, 0)
    bundle.module.eval().requires_grad_(False)
    if on:
        trace.enable()
    with trace.span("teacher"):
        teacher_extract(bundle, torch.rand(2, 32, 32, 3))
    spans = trace.summary()["spans"]
    if not on:
        assert spans == {}
        return
    assert spans["teacher"]["calls"] == 1
    assert spans["teacher_mlp"]["calls"] == 3
    assert spans["teacher_mlp"]["parents"] == ["teacher"]


def test_grad_reduce_span_and_counters():
    from basd_tpu_torch.training.trainer import Trainer

    dp = types.SimpleNamespace(group=object(), world=2,
                               all_reduce_=lambda t: t.mul_(2))
    grads = {"a": torch.ones(3, 4), "b": torch.full((5,), 3.0)}
    trace.enable()
    out = Trainer._reduce_grads(types.SimpleNamespace(dp=dp), grads)
    assert torch.equal(out["a"], grads["a"]) and torch.equal(out["b"],
                                                             grads["b"])
    s = trace.summary()
    assert s["counters"] == {"grad_reduce.calls": 1,
                             "grad_reduce.bytes": 17 * 4}
    assert s["spans"]["grad_reduce"]["calls"] == 1


class FakeEvent:
    """A timing event that completes ``LAG`` steps after it is recorded,
    on a clock of steps (1 ms a tick of ``FakeEvent.now``)."""

    LAG = 1
    now = 0
    made = 0

    def __init__(self):
        FakeEvent.made += 1
        self.at = None

    def record(self):
        self.at = FakeEvent.now

    def query(self):
        return self.at + self.LAG <= FakeEvent.now

    def elapsed_time(self, end):
        return float(end.at - self.at)


def test_folding_keeps_live_records_bounded(monkeypatch):
    monkeypatch.setattr(trace, "_new_event", FakeEvent)
    monkeypatch.setattr(FakeEvent, "now", 0)
    monkeypatch.setattr(FakeEvent, "made", 0)
    synced = []

    def synchronize():
        synced.append(True)
        FakeEvent.now += FakeEvent.LAG

    monkeypatch.setattr(torch.cuda, "synchronize", synchronize)
    trace.enable()
    monkeypatch.setattr(trace, "_events", True)
    per_step = 3
    for _ in range(50):
        with trace.span("step"):
            with trace.span("loss_and_grads"):
                FakeEvent.now += 1
                with trace.span("backward"):
                    FakeEvent.now += 1
        # the steps of at most LAG steps ago wait unfolded, nothing older
        assert len(trace._pending) <= per_step * (FakeEvent.LAG + 1)
    # each folded record gave its two events back for reuse
    assert FakeEvent.made <= 2 * per_step * (FakeEvent.LAG + 2)
    assert not synced
    s = trace.summary()
    assert synced and len(trace._pending) == 0
    spans = s["spans"]
    assert {k: v["calls"] for k, v in spans.items()} == {
        "step": 50, "loss_and_grads": 50, "backward": 50}
    assert spans["step"]["steps"] == 50
    assert spans["loss_and_grads"]["device_ms"] == 100.0
    assert spans["backward"]["device_ms"] == 50.0
    assert spans["loss_and_grads"]["self_device_ms"] == 50.0
    assert spans["step"]["self_device_ms"] == 0.0
    assert trace.per_step(s)["spans"]["loss_and_grads"]["device_ms"] == 2.0


def test_host_only_span_makes_no_event(monkeypatch):
    monkeypatch.setattr(trace, "_new_event", FakeEvent)
    monkeypatch.setattr(FakeEvent, "now", 0)
    monkeypatch.setattr(FakeEvent, "made", 0)
    monkeypatch.setattr(trace, "_free", [])  # no event to reuse

    def synchronize():
        FakeEvent.now += FakeEvent.LAG

    monkeypatch.setattr(torch.cuda, "synchronize", synchronize)
    trace.enable()
    monkeypatch.setattr(trace, "_events", True)
    with trace.span("data_wait", device=False):
        time.sleep(1e-3)
    assert FakeEvent.made == 0
    with trace.span("step"):
        pass
    assert FakeEvent.made == 2
    spans = trace.summary()["spans"]
    assert spans["data_wait"]["device_ms"] == 0.0
    assert spans["data_wait"]["host_ms"] > 0


def test_on_and_off_give_equal_bits(tmp_path):
    def three_steps(on: bool):
        trainer = tiny_trainer(tmp_path / str(on))
        if on:
            trace.enable()
        try:
            losses = [trainer.step(*b)["loss_sum"]
                      for b in batches(trainer, 3)]
        finally:
            trace.disable()
        st = trainer.opt_state
        return torch.stack(losses), st

    loss_off, st_off = three_steps(False)
    loss_on, st_on = three_steps(True)
    assert trace.summary()["spans"]["step"]["calls"] == 3
    assert torch.equal(loss_off, loss_on)
    for f in ("x", "z", "v"):
        a, b = getattr(st_off, f), getattr(st_on, f)
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a), f
    assert (st_off.k, st_off.lr_max, st_off.weight_sum) == (
        st_on.k, st_on.lr_max, st_on.weight_sum)


class TrainSource:
    """Fixed batches of the tiny trainer's canvas for every split."""

    def __init__(self, r: int):
        self.batches = worker.global_batches(r, 2, seed=3)

    def load_batches(self, split, batch_size, r, *, shuffle, seed,
                     drop_last):
        yield from (dict(b) for b in self.batches)


def test_run_trace_writes_one_record_an_epoch(tmp_path):
    trainer = tiny_trainer(tmp_path, "+run.trace=true",
                           "training.num_epochs=2",
                           "+data.limit_train_batches=2",
                           "+data.limit_eval_batches=1")
    trainer.train(TrainSource(worker.canvas(trainer)))
    assert not trace.enabled()  # train() turns it off again
    path = tmp_path / trainer.config.run.name / "metrics.jsonl"
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    traces = [r for r in recs if r["kind"] == "trace"]
    assert [r["epoch"] for r in traces] == [1, 2]
    for r in traces:
        assert r["steps"] == 2
        assert set(r["spans"]) == set(STEP_TREE) | {"data_wait"}
        assert r["spans"]["step"]["calls"] == 1.0
        assert r["spans"]["data_wait"]["calls"] == 1.5  # 2 batches, then end
        assert r["spans"]["data_wait"]["host_ms"] > 0
        assert np.isclose(r["counters"]["eigh.matrices.xla"],
                          trainer.teacher.cfg.depth + 4 + 4
                          * trainer.teacher.cfg.depth)


def test_run_trace_off_writes_no_record(tmp_path):
    trainer = tiny_trainer(tmp_path, "training.num_epochs=1",
                           "+data.limit_train_batches=1",
                           "+data.limit_eval_batches=1")
    assert trainer.config.run.get("trace", False) is False
    trainer.train(TrainSource(worker.canvas(trainer)))
    path = tmp_path / trainer.config.run.name / "metrics.jsonl"
    kinds = {json.loads(line)["kind"]
             for line in path.read_text().splitlines()}
    assert "trace" not in kinds and "epoch" in kinds
