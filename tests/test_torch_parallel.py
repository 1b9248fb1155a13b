"""Data parallelism of the port (``basd_tpu_torch/parallel/mesh.py``) on the
CPU over gloo: a 2-rank run equals the one-process run with the 2-shard
MixUp roll under the JAX package's equivalence contract
(``tests/test_train_e2e.py:290-332``), ``train.main`` runs in 2 ranks with
rank 0 alone writing, the one-process 2-shard step equals the JAX
package's, padded eval rows change no metric, and ``tpu.mesh`` values the
port cannot honour are refused.

The ranks are spawned processes (one intra-op thread each) that meet over
a ``file://`` store under the test's temporary directory, never a fixed
TCP port, and are killed if they outlive ``_JOIN_S``."""

from __future__ import annotations

import json
import multiprocessing as mp
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from basd_tpu.data import augment as jaug
from basd_tpu_torch.data import augment as aug
from basd_tpu_torch.parallel.mesh import (
    DataParallel,
    init_mesh,
    shard_batch,
)
from basd_tpu_torch.training.trainer import StepViews
from tests import torch_dp_worker as worker
from tests.test_train_e2e import _assert_equivalent
from tests.torch_parity import B, C, IMG, f32_polar, make_pair, rel, to_torch

STEPS, WORLD = 2, 2
_JOIN_S = 150.0


def _spawn_ranks(tmp_path, world: int, steps: int, target=worker.rank_main,
                 prefix: str = "rank", join_s: float = _JOIN_S) -> list[dict]:
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target,
                         args=(r, world, str(tmp_path / "store"),
                               str(tmp_path), steps))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + join_s
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    assert not hung, f"{len(hung)} rank(s) hung past {join_s} s"
    assert [p.exitcode for p in procs] == [0] * world
    return [torch.load(tmp_path / f"{prefix}{r}.pt", weights_only=False)
            for r in range(world)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 2-rank gloo run and the one-process run with ``num_shards=2`` on
    the same global batches: each evaluates, trains 2 steps."""
    ranks = _spawn_ranks(tmp_path_factory.mktemp("dp"), WORLD, STEPS)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref = worker.build_trainer(tmp_path_factory.mktemp("one"))
        ref.num_shards = WORLD
        r = worker.canvas(ref)
        ref_eval = ref.evaluate(worker.EvalSource(r))
        ref_mets, ref_params = worker.run_steps(
            ref, worker.global_batches(r, STEPS))
    finally:
        torch.set_num_threads(threads)
    return ranks, (ref_mets, ref_params, ref_eval)


def test_two_ranks_match_one_process_with_two_shards(runs):
    """The contract of ``test_data_parallel_equivalence``: step 1's count,
    correct, ranks and CE (rtol 1e-6) equal, geo within rtol 3e-3, the
    parameters within rtol 0.2 / atol 1e-2. The replicated values (loss
    terms, ranks, mixing weights, parameters) are the same bits on both
    ranks; the ranks' counts, correct and loss sums add up."""
    ranks, (ref_mets, ref_params, _) = runs
    r0, r1 = ranks
    mets = []
    for m0, m1 in zip(r0["mets"], r1["mets"]):
        for k in ("ce", "geo", "ranks", "mix_weights", "rank_cap_hits"):
            np.testing.assert_array_equal(m0[k], m1[k], err_msg=k)
        mets.append({**m0, **{k: m0[k] + m1[k]
                              for k in ("loss_sum", "correct", "count")}})
    for k in r0["params"]:
        np.testing.assert_array_equal(r0["params"][k], r1["params"][k],
                                      err_msg=k)
    assert all(np.isfinite(m["loss_sum"]) for m in mets)
    _assert_equivalent(ref_mets, mets, ref_params, r0["params"])


def test_two_ranks_gradient_scale(runs):
    """Each rank differentiates the replicated global loss, whose sums send
    back N cotangents: the summed gradient is N times the global one and
    the trainer divides by N. The update's first step is scale-free in the
    gradient (g / sqrt(v)), so the contract above would not see a factor
    of 2; the second moment v = (1 - b2) g^2 after step 1 does (4x)."""
    ranks, (ref_mets, _, _) = runs
    for key, v_ref in ref_mets[0]["v"].items():
        assert rel(np.sqrt(ranks[0]["mets"][0]["v"][key]),
                   np.sqrt(v_ref)) <= 2e-2, key


def test_padded_eval_rows_change_no_metric(runs):
    """An eval batch of 5 over 2 ranks pads one row labelled -1: top-1,
    top-5 and count equal the one-process pass (13 images), CE to f32."""
    ranks, (_, _, ref_eval) = runs
    for r in ranks:
        ev = r["eval"]
        assert ev["val_acc"] == ref_eval["val_acc"]
        assert ev["val_acc_top5"] == ref_eval["val_acc_top5"]
        assert ev["loss"] == pytest.approx(ref_eval["loss"], rel=1e-6)
    batch = {"image": np.ones((5, 2, 2, 3), np.uint8),
             "label": np.arange(5, dtype=np.int32)}
    last = shard_batch(DataParallel(rank=1, world=2), batch)
    assert last["label"].tolist() == [3, 4, -1]
    assert not last["image"][-1].any()


def test_cli_two_ranks(tmp_path):
    """``train.main`` in each of 2 ranks over a gloo group the caller made:
    the ranks end with the same parameters and epoch history (train loss,
    accuracy and validation are the global batch's), and rank 0 alone
    wrote the run's files: one line a step in ``metrics.jsonl``, the
    checkpoints and the eval suite's ``metrics.json``."""
    r0, r1 = _spawn_ranks(tmp_path, WORLD, STEPS, worker.cli_rank_main,
                          "cli")
    for k in r0["x"]:
        assert torch.equal(r0["x"][k], r1["x"][k]), k
    assert r0["history"] == r1["history"]
    run = tmp_path / "smoke_synthetic"
    lines = [json.loads(line)
             for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in lines if r["kind"] == "step"] == [0, 1]
    assert (run / "metrics.json").exists()
    assert (run / "checkpoints" / "latest" / "state.pt").exists()


def test_refusals(tmp_path, monkeypatch):
    """A train batch the world does not divide, a grid larger than the
    world (``tpu.mesh.model=2`` in one process) and a ``tpu.mesh.data``
    other than the world size are refused."""
    from basd_tpu_torch.train import main

    batch = {"image": np.zeros((6, 2, 2, 3), np.uint8),
             "label": np.zeros(6, np.int32)}
    with pytest.raises(ValueError, match="not divisible by the data axis"):
        shard_batch(DataParallel(rank=0, world=4), batch, allow_pad=False)
    assert shard_batch(DataParallel(rank=0, world=4), batch)["label"].shape == (2,)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="exceeds the world"):
        init_mesh({"data": 1, "model": 2}, torch.device("cpu"))
    with pytest.raises(ValueError, match="tpu.mesh.data=2"):
        init_mesh({"data": 2, "model": 1}, torch.device("cpu"))
    dp, tp = init_mesh({"data": -1}, torch.device("cpu"))
    assert dp.group is None and tp is None
    with pytest.raises(ValueError, match="exceeds the world"):
        main(["experiment=smoke_synthetic", f"run.output_dir={tmp_path}",
              "tpu.mesh.model=2"], device="cpu")


def test_two_shard_step_matches_jax(monkeypatch, tmp_path):
    """The one-process port with ``num_shards=2`` against the JAX package's
    one-device step with ``mixup_cutmix(..., num_shards=2)``, f32, on the
    same weights, views and MixUp draws: the shard roll's images and
    targets, the loss (rel 1e-4) and v after the step (rel 2e-3), as
    ``test_torch_step.py`` holds the one-shard step."""
    f32_polar(monkeypatch)
    pair = make_pair(tmp_path)
    rng = np.random.default_rng(29)
    clean = jnp.asarray(rng.standard_normal((B, IMG, IMG, 3)), jnp.float32
                        ).astype(jnp.bfloat16)
    augmented = jnp.asarray(rng.standard_normal((B, IMG, IMG, 3)), jnp.float32)
    labels = rng.integers(0, C, B).astype(np.int32)
    key = jax.random.PRNGKey(41)
    jmixed, jtargets = jaug.mixup_cutmix(key, augmented, jnp.asarray(labels),
                                         C, num_shards=2)
    new, jloss, _ = pair.jax_step(pair.state, clean,
                                  jmixed.astype(jnp.bfloat16), jtargets)

    k_choice, k_lam, k_box = jax.random.split(key, 3)
    draws = aug.MixDraws(
        use_mixup=to_torch(jax.random.bernoulli(k_choice, 0.5)).bool(),
        lam=to_torch(jax.random.beta(k_lam, 1.0, 1.0)),
        r_y=to_torch(jax.random.randint(k_box, (), 0, IMG)).long(),
        r_x=to_torch(jax.random.randint(jax.random.fold_in(k_box, 1), (), 0,
                                        IMG)).long())
    lab = torch.from_numpy(labels)
    mixed, targets = aug.mixup_cutmix(draws, to_torch(augmented), lab, C,
                                      num_shards=2)
    assert rel(mixed.numpy(), np.asarray(jmixed)) <= 1e-6
    assert rel(targets.numpy(), np.asarray(jtargets)) <= 1e-6
    whole = aug.mixup_cutmix(draws, to_torch(augmented), lab, C)[1]
    assert rel(whole.numpy(), np.asarray(jtargets)) > 1e-2  # rolls differ

    trainer = pair.trainer
    trainer.num_shards = 2
    m = trainer.step_on_views(
        StepViews(clean=to_torch(clean), mixed=mixed, targets=targets,
                  drop_masks=None), lab)
    loss = (m["loss_sum"] / m["count"]).item()
    assert abs(loss - float(jloss)) <= 1e-4 * abs(float(jloss))
    for k, r in pair.flat(new.v).items():
        assert rel(trainer.opt_state.v[k].numpy(), r) <= 2e-3, k
