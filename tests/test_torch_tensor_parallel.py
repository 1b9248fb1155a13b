"""Tensor parallelism of the port over ``tpu.mesh.model``
(``basd_tpu_torch/parallel/mesh.py``, ``models/layers.py:Block``).

- Uneven and empty shards: for ``model`` 2, 3 and 4 on a block of 3 heads
  (2 + 1; 1 + 1 + 1; 1 + 1 + 1 + 0), the ranks of a model group run as
  threads of this one process with an in-process sum (no process group),
  on every path's plain version: the module chain at f32 (einsum / dense
  and K10 / K11), the f32 MLP kernel path (K4) and the bf16 kernel paths
  of the student (K3 / K4) and the teacher (K1 / K2, importance and the
  collection stack). Each rank's block output and input gradient equal
  the whole block's, its shards' gradients the whole gradients' slices and
  the replicated parameters' gradients the whole ones, the same bits on
  every rank.
- Against the JAX package: 4 spawned gloo ranks, a 2 (data) x 2 (model)
  f32 run of the port, are held to ``basd_tpu``'s one-device run on the
  same ported weights and views (MixUp over 2 shards) by
  ``tests/test_train_e2e.py:_assert_equivalent(..., ce_rtol=2e-5)``, the
  contract of ``test_tensor_sharded_equivalence``; the replicated
  parameters stay bit-equal in each model group; a checkpoint written by
  one process loads into the ranks and theirs into one process; and
  ``train.main`` runs the 2 x 2 grid end to end.
- The split rules, the shard / gather round trip and the refusals.

The spawned ranks meet over a ``file://`` store under the test's temporary
directory (``tests/torch_dp_worker.py``) and are killed if they outlive
``_JOIN_S``."""

from __future__ import annotations

import copy
import json
import threading
from dataclasses import dataclass
from typing import Any

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from basd_tpu.data import augment as jaug
from basd_tpu_torch.models.layers import Block
from basd_tpu_torch.models.port import shard_state_dict, tp_key
from basd_tpu_torch.parallel.mesh import (
    ModelParallel,
    check_shards,
    init_mesh,
    split_range,
)
from tests import torch_dp_worker as worker
from tests.test_torch_parallel import _spawn_ranks
from tests.test_train_e2e import _assert_equivalent
from tests.torch_parity import B, C, IMG, f32_polar, make_pair, rel, to_torch

D, HEADS, MLP_RATIO = 48, 3, 4.0
F = int(D * MLP_RATIO)


class _Threads:
    """The ranks of a model group as threads: ``sum_`` adds the ranks'
    tensors in rank order, every rank the same bits."""

    def __init__(self, world: int):
        self.barrier = threading.Barrier(world, timeout=120)
        self.slots: list = [None] * world

    def sum_(self, rank: int, t: torch.Tensor) -> torch.Tensor:
        self.slots[rank] = t
        self.barrier.wait()
        total = self.slots[0].clone()
        for other in self.slots[1:]:
            total += other
        self.barrier.wait()
        return t.copy_(total)


@dataclass
class _ThreadRank(ModelParallel):
    threads: Any = None

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        return self.threads.sum_(self.rank, t)


def _run_ranks(world: int, fn) -> list:
    """``fn(tp)`` on each of ``world`` thread ranks; their results."""
    threads = _Threads(world)
    out: list = [None] * world
    errors: list = []

    def body(rank):
        try:
            out[rank] = fn(_ThreadRank(rank, world, threads, threads))
        except BaseException as e:  # noqa: BLE001 (re-raised below)
            errors.append(e)
            threads.barrier.abort()

    ts = [threading.Thread(target=body, args=(r,)) for r in range(world)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    if errors:
        raise errors[0]
    return out


# (attention_impl, mlp_impl, dtype, importance_mode)
_STUDENT_PATHS = {
    "chain-f32": ("module", "module", torch.float32),
    "flash-fused-f32": ("flash", "fused", torch.float32),
    "fused_ln-f32": ("module", "fused_ln", torch.float32),
    "kernels-bf16": ("fused_block_train", "fused_ln", torch.bfloat16),
}
_TEACHER_PATHS = {
    "chain-f32": ("module", "module", torch.float32),
    "flash-f32": ("flash", "module", torch.float32),
    "kernels-bf16": ("fused_block", "fused_ln", torch.bfloat16),
}


def _block(attn, mlp, dtype, importance=None, seed=0) -> Block:
    blk = Block(D, HEADS, MLP_RATIO, importance_mode=importance, dtype=dtype,
                attention_impl=attn, mlp_impl=mlp)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in blk.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.2
                    + (1.0 if p.dim() == 1 and p.shape[0] == D else 0.0))
    return blk


def _shard(blk: Block, tp) -> Block:
    mine = copy.deepcopy(blk)
    full = {"blocks.0." + k: v.detach() for k, v in blk.named_parameters()}
    shard = shard_state_dict(full, tp, HEADS)
    mine.set_tp(tp, {k[len("blocks.0."):]: v for k, v in shard.items()
                     if tp_key(k)})
    return mine


def _close(a, b, tol: float, what: str) -> None:
    a, b = a.detach().double(), b.detach().double()
    assert a.shape == b.shape, (what, a.shape, b.shape)
    scale = max(b.abs().max().item(), 1e-30)
    err = (a - b).abs().max().item() / scale
    assert err <= tol, f"{what}: rel {err} > {tol}"


@pytest.mark.parametrize("world", [2, 3, 4])
@pytest.mark.parametrize("path", sorted(_STUDENT_PATHS))
def test_student_block_shares_add_up(path, world):
    """A student block (stochastic depth on) over ``world`` thread ranks:
    output, input gradient and every parameter gradient as the whole
    block's (f32 rel 1e-5; bf16 kernel path rel 2e-2, its outputs rounded
    to bf16), the replicated gradients the same bits on every rank."""
    attn, mlp, dtype = _STUDENT_PATHS[path]
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    whole = _block(attn, mlp, dtype)
    g = torch.Generator().manual_seed(1)
    x0 = torch.randn((2, 5, D), generator=g).to(dtype)
    cot = torch.randn((2, 5, D), generator=g)
    drop = (0.75, torch.tensor([[True, False], [True, True]]))

    def run(blk, tp=None):
        x = x0.clone().requires_grad_(True)
        out, _ = blk(x, drop)
        (out.float() * cot).sum().backward()
        # an empty shard takes no part in the forward (the trainer zeros it)
        grads = {k: torch.zeros_like(p) if p.grad is None else p.grad.clone()
                 for k, p in blk.named_parameters()}
        return out.detach(), x.grad.clone(), grads

    ref_out, ref_dx, ref_grads = run(whole)
    ref_shards = [shard_state_dict({"blocks.0." + k: v for k, v in
                                    ref_grads.items()}, tp, HEADS)
                  for tp in (ModelParallel(r, world) for r in range(world))]
    ranks = _run_ranks(world, lambda tp: run(_shard(whole, tp), tp))
    for r, (out, dx, grads) in enumerate(ranks):
        _close(out, ref_out, tol, f"rank {r} output")
        _close(dx, ref_dx, tol, f"rank {r} dx")
        for k, gk in grads.items():
            ref = ref_shards[r]["blocks.0." + k]
            if gk.numel():
                _close(gk, ref, tol, f"rank {r} {k}")
            if not tp_key("blocks.0." + k):
                assert torch.equal(gk, ranks[0][2][k]), (r, k)
        assert torch.equal(out, ranks[0][0]) and torch.equal(dx, ranks[0][1])


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("path", ["chain-f32", "flash-fused-f32"])
def test_remat_composes(path, policy):
    """A remat'd 2-block student (``remat_policy`` full or dots: the
    recompute runs each half's sum again) over 2 thread ranks on 3 heads
    (2 + 1): logits and every gradient as the whole model's (f32 rel
    1e-5), the replicated gradients the same bits on both ranks."""
    from basd_tpu_torch.models.registry import create_model, init_model
    from basd_tpu_torch.models.vit import shard_vit

    attn, mlp, dtype = _STUDENT_PATHS[path]
    arch = dict(embed_dim=D, depth=2, num_heads=HEADS, patch_size=8)

    def build():
        bundle = create_model("tp_student", img_size=16, num_classes=5,
                              arch_overrides=arch, remat=True,
                              remat_policy=policy, attention_impl=attn,
                              mlp_impl=mlp)
        init_model(bundle, 4, fan_in_init=True)
        return bundle.module

    x = torch.randn((2, 16, 16, 3), generator=torch.Generator().manual_seed(5))

    def run(model):
        out = model(x, deterministic=True)
        (out["logits"].float().square().sum()
         + out["tokens"].float().sum()).backward()
        return out["logits"].detach(), {
            k: torch.zeros_like(p) if p.grad is None else p.grad.clone()
            for k, p in model.named_parameters()}

    ref_logits, ref_grads = run(build())
    ranks = _run_ranks(2, lambda tp: run(shard_vit(build(), tp)))
    for r, (logits, grads) in enumerate(ranks):
        _close(logits, ref_logits, 1e-5, f"rank {r} logits")
        ref = shard_state_dict(ref_grads, ModelParallel(r, 2), HEADS)
        for k, g in grads.items():
            _close(g, ref[k], 1e-5, f"rank {r} {k}")
            if not tp_key(k):
                assert torch.equal(g, ranks[0][1][k]), (r, k)


@pytest.mark.parametrize("world", [2, 3, 4])
@pytest.mark.parametrize("path", sorted(_TEACHER_PATHS))
def test_teacher_block_shares_add_up(path, world):
    """The frozen teacher's block (CLS importance, the collection stack)
    over ``world`` thread ranks: output, importance (each rank's heads
    over the block's head count, summed) and the stack's slab as the whole
    block's (f32 rel 1e-5, bf16 rel 2e-2), the same bits on every rank."""
    attn, mlp, dtype = _TEACHER_PATHS[path]
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    whole = _block(attn, mlp, dtype, importance="cls", seed=2)
    x = torch.randn((2, 5, D), generator=torch.Generator().manual_seed(3)
                    ).to(dtype)

    def run(blk):
        buf = torch.zeros((3 * 2 * 5, D), dtype=dtype)
        with torch.no_grad():
            out, imp = blk(x, buf=buf, idx=1)
        return out, imp, buf

    ref_out, ref_imp, ref_buf = run(whole)
    ranks = _run_ranks(world, lambda tp: run(_shard(whole, tp)))
    for r, (out, imp, buf) in enumerate(ranks):
        _close(out, ref_out, tol, f"rank {r} output")
        _close(imp, ref_imp, 1e-5 if dtype == torch.float32 else 1e-3,
               f"rank {r} importance")
        assert torch.equal(buf, ranks[0][2]) and torch.equal(buf[10:20],
                                                             out.reshape(10, D))
        _close(buf, ref_buf, tol, f"rank {r} stack")


def test_split_rules_and_refusals():
    """Heads and hidden units split as evenly as they go, contiguous, in
    rank order; a shard whose rows break TMA's 16-byte rule is refused
    with its shape named."""
    assert [split_range(3, 2, r) for r in range(2)] == [(0, 2), (2, 3)]
    assert [split_range(3, 4, r) for r in range(4)] == [
        (0, 1), (1, 2), (2, 3), (3, 3)]
    assert [split_range(768, 2, r) for r in range(2)] == [(0, 384), (384, 768)]
    check_shards(2, 192, 3, 768)  # DeiT-Ti: heads 2 + 1, units 384 + 384
    check_shards(4, 192, 3, 768)
    with pytest.raises(ValueError, match=r"fc2 shard \(48, 12\)"):
        check_shards(4, 48, 3, 48)  # 12 units a rank
    with pytest.raises(ValueError, match=r"proj shard \(12, 4\)"):
        check_shards(3, 12, 3, 24)  # heads of 4


def test_shard_round_trip():
    """Concatenating the ranks' shards in rank order gives back each whole
    tensor (what ``gather_state_dict`` does over the group), bit for bit;
    replicated entries are passed through."""
    whole = _block("module", "module", torch.float32)
    sd = {"student.blocks.0." + k: v.detach()
          for k, v in whole.named_parameters()}
    for world in (2, 3, 4):
        shards = [shard_state_dict(sd, ModelParallel(r, world), HEADS)
                  for r in range(world)]
        for k, v in sd.items():
            kind = tp_key(k)
            if kind is None:
                assert all(s[k] is v for s in shards)
                continue
            if kind.startswith("attn.qkv"):
                parts = [torch.cat([s[k].chunk(3)[p] for s in shards])
                         for p in range(3)]
                assert torch.equal(torch.cat(parts), v), k
            else:
                axis = 1 if kind.endswith(("proj.weight", "fc2.weight")) else 0
                assert torch.equal(torch.cat([s[k] for s in shards], axis),
                                   v), k


# -- the 2 x 2 grid against the JAX package ---------------------------------

STEPS, GRID = 2, 4
_JOIN_S = 450.0  # four ranks of a smoke run each, under the suite's load


def _jax_metrics(loss, aux, logits, labels) -> dict:
    correct = (np.asarray(logits).argmax(-1) == labels).sum()
    return {k: np.asarray(v, np.float64) for k, v in {
        "loss_sum": float(loss) * B, "correct": correct, "count": B,
        "ce": aux["ce_loss"], "geo": aux["geo_loss"], "ranks": aux["ranks"],
        "mix_weights": aux["mix_weights"]}.items()}


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    """The JAX package's one-device run on the tiny pair (f32, both polar
    factors in f32), 2 steps on views whose MixUp rolls 2 shards; the same
    weights, one-process checkpoint and views to 4 spawned gloo ranks
    (``torch_dp_worker.tp_rank_main``); then the ranks' checkpoint loaded
    into the one-process port trainer."""
    root = tmp_path_factory.mktemp("tp")
    with pytest.MonkeyPatch.context() as mpatch:
        f32_polar(mpatch)
        pair = make_pair(root / "one")
        trainer, state = pair.trainer, pair.state
        rng = np.random.default_rng(43)
        views, jmets = [], []
        for step in range(STEPS):
            clean = jnp.asarray(rng.standard_normal((B, IMG, IMG, 3)),
                                jnp.float32).astype(jnp.bfloat16)
            augmented = jnp.asarray(rng.standard_normal((B, IMG, IMG, 3)),
                                    jnp.float32)
            labels = rng.integers(0, C, B).astype(np.int32)
            mixed, targets = jaug.mixup_cutmix(
                jax.random.PRNGKey(50 + step), augmented, jnp.asarray(labels),
                C, num_shards=2)
            mixed = mixed.astype(jnp.bfloat16)
            state, loss, aux, logits = pair.jax_metrics_step(
                state, clean, mixed, targets)
            jmets.append(_jax_metrics(loss, aux, logits, labels))
            views.append({"clean": to_torch(clean), "mixed": to_torch(mixed),
                          "targets": to_torch(targets),
                          "labels": torch.from_numpy(labels).long()})
        jparams = {k: v.astype(np.float64) for k, v in pair.flat(
            jax.tree_util.tree_map(np.asarray, _jsf_eval(state))).items()}
        trainer.save_checkpoint("init", 0)
        torch.save({
            "teacher": trainer.teacher.module.state_dict(),
            "student": trainer.student.module.state_dict(),
            "checkpoint": str(trainer._ckpt_dir() / "init"), "views": views,
        }, root / "tp_inputs.pt")
        ranks = _spawn_ranks(root, GRID, STEPS, worker.tp_rank_main, "tp",
                             join_s=_JOIN_S)
        trainer.load_checkpoint(ranks[0]["ckpt_dir"] + "/tp")
        one = {k: v.clone() for k, v in trainer.opt_state.x.items()}
    return {"jax": (jmets, jparams), "ranks": ranks, "one": one,
            "root": root}


def _jsf_eval(state):
    from basd_tpu.training import schedulefree as jsf

    return jsf.eval_params(state)


def test_grid_matches_jax(grid):
    """The contract of ``test_tensor_sharded_equivalence``: the port's
    2 (data) x 2 (model) f32 run against the JAX package's one-device run
    on the same weights and views (MixUp over 2 shards), step 1's count,
    correct and MP ranks equal, CE within rtol 2e-5, geo within 3e-3,
    every parameter (gathered) within rtol 0.2 / atol 1e-2. The data
    ranks' counts, correct and loss sums add up; the replicated values are
    the same bits on all four ranks."""
    jmets, jparams = grid["jax"]
    ranks = grid["ranks"]
    first = ranks[0]
    for other in ranks[1:]:
        for m0, m1 in zip(first["mets"], other["mets"]):
            for k in ("ce", "geo", "ranks", "mix_weights", "rank_cap_hits"):
                np.testing.assert_array_equal(m0[k], m1[k], err_msg=k)
        for k in first["params"]:
            np.testing.assert_array_equal(first["params"][k],
                                          other["params"][k], err_msg=k)
    mets = [{**m0, **{k: m0[k] + m2[k]
                      for k in ("loss_sum", "correct", "count")}}
            for m0, m2 in zip(ranks[0]["mets"], ranks[2]["mets"])]
    assert all(np.isfinite(m["loss_sum"]) for m in mets)
    _assert_equivalent(jmets, mets, jparams, first["params"], ce_rtol=2e-5)


def test_replicated_parameters_bit_equal(grid):
    """After 2 steps the replicated parameters (everything but the blocks'
    qkv, proj, fc1 and fc2 shards) are the same bits on the two ranks of
    each model group and across the groups; the shards differ."""
    ranks = grid["ranks"]
    for k, v in ranks[0]["local"].items():
        same = [torch.equal(r["local"][k], v) for r in ranks[1:]]
        if tp_key(k):
            assert not same[0], k  # rank 1 holds the other shard
        else:
            assert all(same), k


def test_checkpoint_round_trip(grid):
    """One process -> grid: the ranks loaded the one-process checkpoint and
    kept exactly their modules' own shards. Grid -> one process: the
    checkpoint rank 0 wrote loads into the one-process trainer, each entry
    the gathered eval point's whole tensor, bit for bit."""
    ranks = grid["ranks"]
    assert all(r["loaded_equal"] for r in ranks)
    for k, v in grid["one"].items():
        assert tuple(v.shape) == ranks[0]["params"][k].shape, k
    ckpt = torch.load(grid["ranks"][0]["ckpt_dir"] + "/tp/state.pt",
                      weights_only=True)
    for k in ("x", "z", "v"):
        assert set(ckpt[k]) == set(grid["one"])


def test_cli_on_the_grid(grid):
    """``train.main`` under ``tpu.mesh.data=2 tpu.mesh.model=2``: the
    ranks' histories agree, each model group's ranks hold the two shards
    and the same replicated entries, and rank 0 alone wrote the run's
    files, the checkpoint and weights in the one-process format (whole
    tensors) and ``metrics.json`` with the whole student's parameter
    count."""
    ranks = grid["ranks"]
    for r in ranks[1:]:
        assert r["cli_history"] == ranks[0]["cli_history"]
    x0, x1 = ranks[0]["cli_x"], ranks[1]["cli_x"]
    for k in x0:
        if not tp_key(k):
            assert torch.equal(x0[k], x1[k]), k
    run = grid["root"] / "cli" / "smoke_synthetic"
    state = torch.load(run / "checkpoints" / "latest" / "state.pt",
                       weights_only=True)
    weights = torch.load(run / "checkpoints" / "final_model_weights.pt",
                         weights_only=True)
    whole = 0
    for k, v in state["x"].items():
        if tp_key(k):
            assert v.shape[0] + (v.shape[1] if v.dim() == 2 else 0) > (
                x0[k].shape[0] + (x0[k].shape[1] if x0[k].dim() == 2 else 0)), k
        if k.startswith("student."):
            assert tuple(weights[k[len("student."):]].shape) == tuple(v.shape)
            whole += v.numel()
    metrics = json.loads((run / "metrics.json").read_text())
    assert metrics["efficiency"]["param_count"] == whole
    lines = (run / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(x)["step"] for x in lines
            if json.loads(x)["kind"] == "step"] == [0]


def test_mesh_refusals(monkeypatch):
    """A grid larger than the world and a ``data`` other than world /
    model are refused; ``model: 1`` gives no model group."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="exceeds the world"):
        init_mesh({"data": -1, "model": 2}, cpu)
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(ValueError, match=r"tpu.mesh.data=3 x tpu.mesh.model=2 exceeds"):
        init_mesh({"data": 3, "model": 2}, cpu)
    with pytest.raises(ValueError, match="tpu.mesh.data=1"):
        init_mesh({"data": 1, "model": 2}, cpu)
    with pytest.raises(ValueError, match="exceeds the world"):
        init_mesh({"data": 1, "model": 8}, cpu)
    monkeypatch.setenv("WORLD_SIZE", "1")
    dp, tp = init_mesh({"data": -1, "model": 1}, cpu)
    assert dp.group is None and tp is None


def test_mesh_keeps_a_one_rank_group(tmp_path, monkeypatch):
    """A caller's process group of one rank is kept (every collective then
    runs, as the world-1 check of ``chip_smoke.py`` needs), with no model
    group for ``model: 1``; a grid of 1 x 2 is refused on it."""
    import torch.distributed as dist

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        dp, tp = init_mesh({"data": 1, "model": 1}, torch.device("cpu"))
        assert dp.group is not None and dp.world == 1 and tp is None
        with pytest.raises(ValueError, match="exceeds the world"):
            init_mesh({"data": 1, "model": 2}, torch.device("cpu"))
    finally:
        dist.destroy_process_group()
