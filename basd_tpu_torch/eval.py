"""Eval entry point of the port (counterpart of ``basd_tpu/eval.py``;
reference ``src/eval.py:14-41``): rebuild the student from the persisted
``model.arch_overrides``, load its weights, run the eval suite and write
``metrics.json``::

    python -m basd_tpu_torch.eval experiment=... \
        checkpoint.path=outputs/<name>/checkpoints/best_model_weights

``checkpoint.path`` is the trainer's weights file (without its ``.pt``) or
a ``.pth`` export (``basd_tpu_torch.models.export``). Pass the trained
student's ``+model.arch_overrides.*`` when the trainer derived its arch
(the ``student_arch_derived`` line, or the run's ``config.yaml``). Runs on
one CUDA device by default and raises when none is present;
``main(argv, device="cpu")`` runs on the CPU. Under ``torchrun`` the mesh is
checked as ``train.py`` checks it (``tpu.mesh``) and rank 0 runs the suite
(with ``tpu.mesh.model > 1`` the ranks of its model group, on the student's
blocks cut to their shards, rank 0 writing); the other ranks return an
empty dict.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

from basd_tpu_torch.config import compose, register_resolvers, save_config
from basd_tpu_torch.evaluation.metrics import run_eval_suite, save_metrics
from basd_tpu_torch.models.export import build_student, load_student_weights
from basd_tpu_torch.models.vit import shard_vit
from basd_tpu_torch.ops.linalg import set_full_f32_precision
from basd_tpu_torch.parallel.mesh import init_mesh
from basd_tpu_torch.train import _CONFIG_DIR, cli, resolve_device


def main(argv: list[str] | None = None,
         device: str | torch.device = "cuda") -> dict:
    device = resolve_device(device)
    register_resolvers()
    set_full_f32_precision()
    config = compose(_CONFIG_DIR,
                     overrides=list(sys.argv[1:] if argv is None else argv))
    dp, tp = init_mesh(config.tpu.get("mesh"), device)
    try:
        results = _evaluate(config, device, tp) if dp.is_main else {}
        dp.barrier()
        return results
    finally:
        dp.close()


def _evaluate(config, device: torch.device, tp=None) -> dict:
    np.random.seed(config.run.seed)
    torch.manual_seed(config.run.seed)
    if not config.checkpoint.path:
        raise SystemExit("checkpoint.path is required for the eval")

    bundle = build_student(config, device)
    epoch = load_student_weights(bundle.module, config.checkpoint.path)
    writer = tp is None or tp.rank == 0
    if tp is not None:
        shard_vit(bundle.module, tp)
    if writer:
        print(f"checkpoint_loaded path={config.checkpoint.path} "
              f"epoch={epoch}")

    output_dir = Path(config.run.output_dir) / config.run.name
    output_dir.mkdir(parents=True, exist_ok=True)
    if writer:
        save_config(config, output_dir / "config.yaml")
    results = run_eval_suite(
        bundle.module, config, config_path=str(output_dir / "config.yaml"),
        efficiency_batches=int(config.get("eval", {}).get(
            "efficiency_batches", 200)),
        tp=tp,
    )
    if writer:
        save_metrics(results, output_dir)
    return results


if __name__ == "__main__":
    cli(main)
