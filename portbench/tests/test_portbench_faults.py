"""The check fails what it exists to catch. On the CPU at tiny widths,
without the harness's look for a card, a whole run with the timed path
broken underneath comes out not correct, once for each fault a one-chip
training cell can have: a step that leaves its state unchanged, half of
the batch left out (the mean over the rest), an answer altered where it
is produced (a gradient doubled). The control, the reference one
precision step down in the program's place, fails too. (The tiny cell's
limits: above its unbroken readings, which Adam's first steps leave
larger than at the cells' widths; the cells' own limits are in
``portbench/limits``, set from the card's readings.)"""

import functools
import time

import pytest
import torch

from portbench import bench, check
from portbench.reference.arith import Arith
from portbench.reference.step import FAULT_LEAF, reference_steps
from portbench.tests.tiny import tiny_cell

TINY_LIMITS = {"loss_gap": 2e-2, "grad_gap": 5e-3, "grad_median_gap": 2e-3,
               "change_gap": 5e-2, "change_median_gap": 2e-2}
SEED = 2 ** 32 + 11


def frozen(trainer, monkeypatch):
    from basd_tpu_torch.training import schedulefree

    monkeypatch.setattr(schedulefree, "update",
                        lambda state, *a, **k: state)


def half(trainer, monkeypatch):
    step = trainer.step

    def half_step(images, labels):
        b = images.shape[0] // 2
        return step(images[:b], labels[:b])

    trainer.step = half_step


def doubled(trainer, monkeypatch):
    grads_of = trainer.loss_and_grads

    def altered(*args, **kwargs):
        loss, aux, logits, grads, y = grads_of(*args, **kwargs)
        grads[FAULT_LEAF] = 2.0 * grads[FAULT_LEAF]
        return loss, aux, logits, grads, y

    trainer.loss_and_grads = altered


def run(monkeypatch, prepare=None):
    torch.set_num_threads(2)
    monkeypatch.setattr(bench, "reference_steps", functools.partial(
        reference_steps, arith=Arith("f32", polar_dtype=torch.bfloat16)))
    cell = tiny_cell(limits=TINY_LIMITS)
    hook = None if prepare is None else functools.partial(
        prepare, monkeypatch=monkeypatch)
    return bench.run(cell, SEED, 0.01, False, time.perf_counter(),
                     device="cpu", prepare=hook)


def test_unbroken_run_is_correct(monkeypatch):
    assert run(monkeypatch)["correct"]


@pytest.mark.parametrize("fault", [frozen, half, doubled])
def test_broken_run_is_not_correct(fault, monkeypatch):
    result = run(monkeypatch, fault)
    assert not result["correct"], result["checks"]


def test_control_is_not_correct():
    torch.set_num_threads(2)
    cell = tiny_cell()
    ref = reference_steps(cell.config, cell.traffic, SEED, "cpu")
    control = reference_steps(cell.config, cell.traffic, SEED, "cpu",
                              arith="control")
    ok, checks = check.judge(check.readings(control, ref), TINY_LIMITS)
    assert not ok, checks


@pytest.mark.card
def test_control_fails_the_cell_limits_on_the_card(card):
    from portbench.cells import load_cell
    from portbench.control import readings

    cell = load_cell("dinov2_b14-s320_gram.b256")
    row = readings(cell, 2 ** 31 + 21, ["control"], card, print)[0]
    ok, checks = check.judge(row, cell.limits)
    assert not ok, checks
