"""Tiny port trainers for ``tests/test_torch_parallel.py``, and the body of
one rank of its gloo group. Imports no JAX: spawned ranks import this
module alone."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

IMG, PATCH, C, BATCH = 32, 8, 10, 8
T_ARCH = dict(embed_dim=64, depth=4, num_heads=4, patch_size=PATCH)
S_ARCH = dict(embed_dim=32, depth=4, num_heads=2, patch_size=PATCH)
EVAL_SIZES = (8, 5)  # the second eval batch pads on 2 ranks


def config(out_dir, world: int):
    from basd_tpu_torch.config import compose, register_resolvers
    from basd_tpu_torch.train import _CONFIG_DIR

    register_resolvers()
    return compose(_CONFIG_DIR, overrides=[
        "experiment=smoke_synthetic", "data.dataset=synthetic/tiny",
        f"run.output_dir={out_dir}", f"model.vit.img_size={IMG}",
        f"model.vit.patch_size={PATCH}", f"data.batch_size={BATCH}",
        "basd.teacher_model_name=tiny_teacher", f"tpu.mesh.data={world}",
    ])


def build_trainer(out_dir, world: int = 1, dp=None):
    """Packed-collection f32 teacher, f32 student with stochastic depth,
    both from fixed seeds, on the CPU."""
    from basd_tpu_torch.models.registry import create_model, init_model
    from basd_tpu_torch.training.trainer import Trainer

    cfg = config(out_dir, world)
    teacher = create_model("tiny_teacher", img_size=IMG, arch_overrides=T_ARCH,
                           importance_mode="cls", collect=True)
    init_model(teacher, 0)
    teacher.module.eval().requires_grad_(False)
    student = create_model("tiny_student", img_size=IMG, num_classes=C,
                           drop_path_rate=0.1, arch_overrides=S_ARCH)
    init_model(student, 1, fan_in_init=True)
    return Trainer(cfg, student_bundle=student, teacher_bundle=teacher,
                   device=torch.device("cpu"),
                   dataset_stats=((0.5,) * 3, (0.25,) * 3),
                   teacher_stats=(teacher.mean, teacher.std), dp=dp)


def canvas(trainer) -> int:
    return round(IMG / trainer.config.data.eval_crop_ratio)


def global_batches(r: int, steps: int, seed: int = 0) -> list[dict]:
    rng = np.random.default_rng(seed)
    return [{"image": rng.integers(0, 256, (BATCH, r, r, 3), np.uint8),
             "label": rng.integers(0, C, (BATCH,)).astype(np.int32)}
            for _ in range(steps)]


def run_steps(trainer, batches: list[dict]):
    """Train steps on the given global batches (this rank's rows of each):
    per-step metrics with the optimizer's second moment ``v`` after the
    step, and the final eval-point parameters, in float64."""
    from basd_tpu_torch.parallel.mesh import shard_batch
    from basd_tpu_torch.training import schedulefree as sf

    mets = []
    for batch in batches:
        local = shard_batch(trainer.dp, batch, allow_pad=False)
        m = trainer.step(*trainer.to_device(local))
        mets.append({k: np.asarray(v.detach().double().numpy())
                     for k, v in m.items()})
        mets[-1]["v"] = {k: v.double().numpy()
                         for k, v in trainer.opt_state.v.items()}
    params = {k: v.double().numpy()
              for k, v in sf.eval_params(trainer.opt_state).items()}
    return mets, params


class EvalSource:
    """An eval split of batches of ``EVAL_SIZES`` images, fixed."""

    def __init__(self, r: int, seed: int = 5):
        rng = np.random.default_rng(seed)
        self.batches = [
            {"image": rng.integers(0, 256, (n, r, r, 3), np.uint8),
             "label": rng.integers(0, C, (n,)).astype(np.int32)}
            for n in EVAL_SIZES]

    def load_batches(self, split, batch_size, r, *, shuffle, seed, drop_last):
        yield from (dict(b) for b in self.batches)


def rank_main(rank: int, world: int, init_file: str, out_dir: str,
              steps: int) -> None:
    """One rank: a gloo group from ``init_file``, ``evaluate`` on
    ``EvalSource``, then ``steps`` train steps; writes ``rank<r>.pt``."""
    import torch.distributed as dist

    from basd_tpu_torch.parallel.mesh import init_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        cfg = config(out_dir, world)
        dp, _ = init_mesh(cfg.tpu.mesh, torch.device("cpu"))
        trainer = build_trainer(Path(out_dir) / f"r{rank}", world, dp)
        evals = trainer.evaluate(EvalSource(canvas(trainer)))
        mets, params = run_steps(trainer, global_batches(canvas(trainer),
                                                         steps))
        torch.save({"mets": mets, "params": params, "eval": evals},
                   Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def cli_rank_main(rank: int, world: int, init_file: str, out_dir: str,
                  steps: int) -> None:
    """One rank of ``train.main`` on the CPU over a gloo group from
    ``init_file``: a tiny smoke run of ``steps`` steps of the global batch
    of 16; writes the eval point x and the epoch history to
    ``cli<r>.pt``."""
    import torch.distributed as dist

    from basd_tpu_torch.train import main

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        trainer = main([
            "experiment=smoke_synthetic", f"run.output_dir={out_dir}",
            "data.batch_size=16", f"+data.limit_train_batches={steps}",
            "+data.limit_eval_batches=1", "+eval.efficiency_batches=2",
            f"tpu.mesh.data={world}"], device="cpu")
        torch.save({"x": {k: v.clone() for k, v in trainer.opt_state.x.items()},
                    "history": dict(trainer.metrics_history)},
                   Path(out_dir) / f"cli{rank}.pt")
    finally:
        dist.destroy_process_group()


# -- tensor parallelism (tests/test_torch_tensor_parallel.py) ---------------

TP_MESH = {"data": 2, "model": 2}
# the compose overrides of tests/torch_parity.py's tiny pair
PAIR_OVERRIDES = [
    "experiment=smoke_synthetic", "model.vit.img_size=32",
    "model.vit.patch_size=8", "model.drop_path_rate=0.0",
    "basd.teacher_model_name=tiny_teacher", "data.dataset=synthetic/tiny",
]
PAIR_T_ARCH = dict(embed_dim=64, depth=4, num_heads=4, patch_size=8)
PAIR_S_ARCH = dict(embed_dim=32, depth=4, num_heads=2, patch_size=8)


def _f32_polar() -> None:
    """The port's polar factor in f32 (``torch_parity.f32_polar``)."""
    import functools

    from basd_tpu_torch.ops import linalg

    linalg.newton_schulz_polar = functools.partial(
        linalg.newton_schulz_polar, inner_dtype=torch.float32)


def tp_pair_trainer(out_dir, inputs: dict, dp, tp):
    """The tiny pair's port trainer on the given weights, its ViTs cut to
    this rank's shards."""
    from basd_tpu_torch.config import compose, register_resolvers
    from basd_tpu_torch.models.registry import create_model
    from basd_tpu_torch.models.vit import shard_vit
    from basd_tpu_torch.train import _CONFIG_DIR
    from basd_tpu_torch.training.trainer import Trainer

    register_resolvers()
    config = compose(_CONFIG_DIR, overrides=PAIR_OVERRIDES + [
        f"run.output_dir={out_dir}"])
    teacher = create_model("tiny_teacher", img_size=32,
                           arch_overrides=PAIR_T_ARCH, importance_mode="cls",
                           collect=True)
    teacher.module.load_state_dict(inputs["teacher"])
    teacher.module.eval().requires_grad_(False)
    student = create_model("tiny_student", img_size=32, num_classes=C,
                           arch_overrides=PAIR_S_ARCH)
    student.module.load_state_dict(inputs["student"])
    shard_vit(teacher.module, tp)
    shard_vit(student.module, tp)
    return Trainer(config, student_bundle=student, teacher_bundle=teacher,
                   device=torch.device("cpu"),
                   dataset_stats=((0.5,) * 3, (0.25,) * 3),
                   teacher_stats=(teacher.mean, teacher.std), dp=dp, tp=tp)


def tp_rank_main(rank: int, world: int, init_file: str, out_dir: str,
                 steps: int) -> None:
    """One rank of a 2 x 2 grid over a gloo group from ``init_file``:

    1. the tiny pair's trainer on ``tp_inputs.pt``'s weights, which loads
       the one-process checkpoint written there (its student's entries
       re-sharded), then ``steps`` steps on the given views (this data
       rank's rows), then writes checkpoint ``tp`` (rank 0);
    2. ``train.main`` of a smoke run on the same grid.

    Writes ``tp<r>.pt``: per-step metrics, the gathered eval point x, this
    rank's own replicated entries, whether the loaded shards equal the
    modules' own cut, and the smoke run's eval point and history."""
    import torch.distributed as dist

    from basd_tpu_torch.parallel.mesh import init_mesh
    from basd_tpu_torch.train import main
    from basd_tpu_torch.training import schedulefree as sf
    from basd_tpu_torch.training.trainer import StepViews

    torch.set_num_threads(1)
    _f32_polar()
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        dp, tp = init_mesh(TP_MESH, torch.device("cpu"))
        inputs = torch.load(Path(out_dir) / "tp_inputs.pt", weights_only=False)
        trainer = tp_pair_trainer(Path(out_dir) / f"r{rank}", inputs, dp, tp)
        own = {"student." + k: p.detach().clone()
               for k, p in trainer.student.module.named_parameters()}
        trainer.load_checkpoint(inputs["checkpoint"])
        loaded_equal = all(torch.equal(trainer.opt_state.x[k], v)
                           for k, v in own.items())
        mets = []
        for v in inputs["views"]:
            rows = dp.rows(v["labels"].shape[0])
            m = trainer.step_on_views(
                StepViews(clean=v["clean"][rows], mixed=v["mixed"][rows],
                          targets=v["targets"][rows], drop_masks=None),
                v["labels"][rows])
            mets.append({k: np.asarray(t.detach().double().numpy())
                         for k, t in m.items()})
        local = sf.eval_params(trainer.opt_state)
        whole = trainer._whole(local)
        trainer.save_checkpoint("tp", steps - 1)
        cli = main(["experiment=smoke_synthetic",
                    f"run.output_dir={Path(out_dir) / 'cli'}",
                    "data.batch_size=16", "+data.limit_train_batches=1",
                    "+data.limit_eval_batches=1", "+eval.efficiency_batches=2",
                    "tpu.mesh.data=2", "tpu.mesh.model=2"], device="cpu")
        torch.save({
            "mets": mets, "loaded_equal": loaded_equal,
            "params": {k: t.double().numpy() for k, t in whole.items()},
            "local": {k: t.clone() for k, t in local.items()},
            "cli_x": {k: t.clone() for k, t in cli.opt_state.x.items()},
            "cli_history": dict(cli.metrics_history),
            "ckpt_dir": str(trainer._ckpt_dir()),
        }, Path(out_dir) / f"tp{rank}.pt")
    finally:
        dist.destroy_process_group()
