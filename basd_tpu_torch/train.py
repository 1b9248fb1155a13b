"""Training entry point of the port (counterpart of ``basd_tpu/train.py``).

Same hydra-style overrides as ``basd-train``::

    python -m basd_tpu_torch.train experiment=smoke_synthetic training.num_epochs=1

compose -> ``load_teacher`` -> for a ViT teacher, calibration (MP
intrinsic dimension of the teacher's last layer) and
``derive_student_arch``; for a CNN teacher (``feature_format`` 'nhwc', e.g.
``experiment=basd_imagenet_cross_arch``) the ``model.student_preset`` as it
stands -> student -> ``Trainer.train`` -> the eval suite on the student's
eval weights (``evaluation.metrics.run_eval_suite``; ``+eval.efficiency_batches``
sets the timed forwards, 200 by default) -> ``metrics.json`` beside the
run's ``config.yaml``. ``tpu.teacher_attention_impl``,
``tpu.student_attention_impl`` and ``tpu.student_mlp_impl`` select the
blocks' kernel dispatch, as in the JAX package (``auto``: the fused
kernels on CUDA; ``flash`` / ``fused``: the module chain with the K10
attention and the K11 MLP; ``module``: the plain chain);
``tpu.remat_policy`` the student's recompute (null / ``full``, or ``dots``:
keep the products and the flash attention's output, recompute the rest).
Runs on one CUDA device by default and raises when none is present;
``main(argv, device="cpu")`` runs on the CPU.

Data parallelism (``parallel.mesh``, ``tpu.mesh.data``): one process per
GPU under ``torchrun``, each on ``cuda:LOCAL_RANK`` over NCCL::

    torchrun --nproc_per_node=4 -m basd_tpu_torch.train \
        experiment=smoke_synthetic tpu.mesh.data=4

``data.batch_size`` is the global batch and must be a multiple of the
world size. A caller that initialised a default process group itself
(e.g. gloo over CPU processes) trains over it. Rank 0 writes the logs,
checkpoints, ``config.yaml`` and ``metrics.json`` and runs the eval suite.

Tensor parallelism (``tpu.mesh.model``): the world is ``data x model``
ranks (``parallel.mesh.init_mesh``), each ViT block split over the ranks of
a model group (``models.vit.shard_vit``)::

    torchrun --nproc_per_node=4 -m basd_tpu_torch.train \
        experiment=smoke_synthetic tpu.mesh.data=2 tpu.mesh.model=2

``data.batch_size`` is then a multiple of ``tpu.mesh.data``. On the CPU the
same command with ``--device=cpu`` runs the ranks over gloo. The ranks of
data group 0 run the eval suite on the sharded student together; rank 0
of the grid writes, the whole (gathered) state in the one-process format.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

import numpy as np
import torch

from basd_tpu_torch.config import compose, register_resolvers, save_config
from basd_tpu_torch.data.sources import source_from_config, stats_from_config
from basd_tpu_torch.data.augment import make_eval_view
from basd_tpu_torch.evaluation.metrics import run_eval_suite, save_metrics
from basd_tpu_torch.models import (
    create_model,
    derive_student_arch,
    estimate_intrinsic_dim,
    init_model,
    load_teacher,
    probe,
)
from basd_tpu_torch.ops.linalg import set_full_f32_precision
from basd_tpu_torch.models.vit import shard_vit
from basd_tpu_torch.parallel.mesh import DataParallel, ModelParallel, init_mesh
from basd_tpu_torch.training.trainer import Trainer

_CONFIG_DIR = Path(__file__).parent.parent / "configs"


def resolve_device(device: str | torch.device) -> torch.device:
    """``device``, with a bare ``cuda`` taken as this process's card
    (``cuda:LOCAL_RANK`` under ``torchrun``) and made current; raises
    for CUDA without a card."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port trains on a GPU (pass device='cpu' "
            "explicitly to run on the CPU)"
        )
    if device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    torch.cuda.set_device(device)
    return device


def main(argv: list[str] | None = None,
         device: str | torch.device = "cuda") -> Trainer:
    device = resolve_device(device)
    register_resolvers()
    set_full_f32_precision()
    overrides = list(sys.argv[1:] if argv is None else argv)
    config = compose(_CONFIG_DIR, overrides=overrides)
    dp, tp = init_mesh(config.tpu.get("mesh"), device)
    try:
        return _train(config, device, dp, tp)
    finally:
        dp.close()


def _train(config, device: torch.device, dp: DataParallel,
           tp: ModelParallel | None = None) -> Trainer:
    output_dir = Path(config.run.output_dir) / config.run.name
    trainer = build_trainer(config, device, dp, tp)
    if trainer.writer:
        save_config(config, output_dir / "config.yaml")
    start_epoch = 0
    if config.checkpoint.resume_from:
        start_epoch = trainer.load_checkpoint(config.checkpoint.resume_from)
    trainer.train(source_from_config(config), start_epoch=start_epoch)

    if dp.is_main:  # the whole model group of data rank 0
        results = run_eval_suite(
            trainer.eval_student(), config,
            config_path=str(output_dir / "config.yaml"),
            efficiency_batches=int(config.get("eval", {}).get(
                "efficiency_batches", 200)),
            tp=tp,
        )
        if trainer.writer:
            save_metrics(results, output_dir)
    dp.barrier()
    return trainer


def build_trainer(config, device: torch.device,
                  dp: DataParallel | None = None,
                  tp: ModelParallel | None = None) -> Trainer:
    """The composed run's teacher, calibrated student and ``Trainer`` on
    ``device`` (this rank's, with ``dp``; with ``tp`` the ViTs' blocks cut
    to this rank's shards), seeded from ``run.seed``."""
    dp = dp or DataParallel()
    np.random.seed(config.run.seed)
    torch.manual_seed(config.run.seed)

    output_dir = Path(config.run.output_dir) / config.run.name
    output_dir.mkdir(parents=True, exist_ok=True)
    img_size = config.model.vit.img_size
    compute_dtype = torch.bfloat16
    writer = dp.is_main and (tp is None or tp.rank == 0)
    log = print if writer else (lambda *a, **k: None)
    log(f"device={device} "
        f"name={torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'}")
    distributed = dp.group is not None or tp is not None
    log(f"data_parallel world={dp.world} "
        f"model_parallel world={tp.world if tp else 1} "
        f"backend={torch.distributed.get_backend() if distributed else None}")

    teacher_arch = config.basd.get("teacher_arch")
    teacher = load_teacher(
        config.basd.teacher_model_name, img_size, device=device,
        seed=config.run.seed,
        checkpoint_path=config.basd.get("teacher_checkpoint"),
        dtype=compute_dtype,
        arch_overrides=(
            teacher_arch.to_dict() if hasattr(teacher_arch, "to_dict")
            else dict(teacher_arch) if teacher_arch else None
        ),
        attention_impl=config.tpu.get("teacher_attention_impl", "auto"),
    )
    if tp is not None and teacher.info["feature_format"] == "token":
        shard_vit(teacher.module, tp)  # a CNN teacher stays whole

    # calibration: intrinsic-dim student auto-sizing for a token teacher
    # (reference src/train.py:88-114)
    arch_overrides = None
    if teacher.info["feature_format"] == "token":
        arch_overrides = calibrate(config, teacher, device, compute_dtype, dp,
                                   log)
        config.model.arch_overrides = dict(arch_overrides)

    student = create_model(
        config.model.student_preset, img_size=img_size,
        num_classes=config.model.num_classes,
        drop_path_rate=config.model.drop_path_rate,
        arch_overrides=arch_overrides, importance_mode=None,
        remat=bool(config.tpu.get("remat", True)),
        remat_policy=config.tpu.get("remat_policy"), dtype=compute_dtype,
        attention_impl=config.tpu.get("student_attention_impl", "auto"),
        mlp_impl=config.tpu.get("student_mlp_impl", "auto"),
    )
    init_model(student, config.run.seed, fan_in_init=True)
    if tp is not None:
        shard_vit(student.module, tp)
    s_info = probe(student)
    log(
        f"student_probed embed_dim={s_info['embed_dim']} "
        f"depth={s_info['depth']} num_tokens={s_info['num_tokens']} "
        f"heads_per_layer={s_info['heads_per_layer']} "
        f"has_cls={s_info['has_cls_token']} "
        f"attn_subpath={s_info['attn_subpath']}"
    )

    return Trainer(
        config, student_bundle=student, teacher_bundle=teacher,
        device=device, dataset_stats=stats_from_config(config),
        teacher_stats=(teacher.mean, teacher.std), dp=dp, tp=tp,
    )


def calibrate(config, teacher, device: torch.device,
              compute_dtype: torch.dtype,
              dp: DataParallel | None = None, log=print) -> dict:
    """The student's arch from the MP rank of the teacher's last-layer
    tokens over ~10 D_t tokens of eval-view train images. Every rank
    calibrates on the same images; rank 0's rank is taken by all."""
    dp = dp or DataParallel()
    img_size = config.model.vit.img_size
    source = source_from_config(config)
    tokens_per_image = (img_size // config.model.vit.patch_size) ** 2
    num_calib = -(-10 * teacher.info["embed_dim"] // tokens_per_image)
    r = round(img_size / config.data.eval_crop_ratio)
    calib = next(source.load_batches("train", num_calib, r, shuffle=False,
                                     seed=0, drop_last=False))
    calib_images = make_eval_view(
        torch.from_numpy(calib["image"]).to(device), img_size,
        (tuple(teacher.mean), tuple(teacher.std)),
    )
    intrinsic_dim = estimate_intrinsic_dim(teacher,
                                           calib_images.to(compute_dtype))
    intrinsic_dim = int(dp.broadcast_(
        torch.tensor([intrinsic_dim], device=device)).item())
    arch_overrides = derive_student_arch(teacher.info, intrinsic_dim)
    if dp.is_main:
        log(
            f"student_arch_derived intrinsic_dim={intrinsic_dim} "
            f"embed_dim={arch_overrides['embed_dim']} "
            f"depth={arch_overrides['depth']} "
            f"num_heads={arch_overrides['num_heads']} "
            f"mlp_ratio={arch_overrides['mlp_ratio']:.1f}"
        )
    return arch_overrides


def cli(entry=None, argv: list[str] | None = None):
    """The command line of ``entry`` (default this module's ``main``):
    hydra-style overrides, and ``--device=cpu`` (or another device) to run
    off the default CUDA card, e.g. each rank of a CPU grid under
    ``torchrun`` (gloo)."""
    args = list(sys.argv[1:] if argv is None else argv)
    devices = [a.split("=", 1)[1] for a in args if a.startswith("--device=")]
    return (entry or main)([a for a in args if not a.startswith("--device=")],
                           device=devices[-1] if devices else "cuda")


if __name__ == "__main__":
    cli()
