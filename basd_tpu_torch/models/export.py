"""Student export to a timm-layout torch checkpoint (counterpart of
``basd_tpu/models/export.py``).

The reference's tooling reads ``{epoch, model_state_dict}`` ``.pth`` files
with timm ``VisionTransformer`` key names (``src/training/trainer.py:105-111``
writes them, ``src/eval.py:29-31`` loads them). The port's modules keep
timm's names and (out, in) layouts, so the export is the student's
``state_dict`` in that wrapper, f32 on the CPU; both packages'
``load_teacher(checkpoint_path=...)`` and ``basd_tpu_torch.eval`` read it.

CLI: rebuild the student as ``basd_tpu_torch.eval`` does, load the
trainer's weights file (``checkpoints/best_model_weights``) and write the
``.pth``::

    python -m basd_tpu_torch.models.export experiment=... \
        checkpoint.path=outputs/.../checkpoints/best_model_weights \
        +export.path=student.pth
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

from basd_tpu_torch.models import port
from basd_tpu_torch.utils import checkpoint as ckpt


def save_torch_checkpoint(path, state_dict: dict,
                          epoch: int | None = None) -> int:
    """Write ``{'model_state_dict', ['epoch']}`` with f32 CPU tensors;
    returns the number of tensors written."""
    sd = {k: v.detach().to("cpu", torch.float32).contiguous()
          for k, v in state_dict.items()}
    payload: dict = {"model_state_dict": sd}
    if epoch is not None:
        payload["epoch"] = int(epoch)
    torch.save(payload, str(path))
    return len(sd)


def build_student(config, device: torch.device):
    """The student of ``config`` (``model.student_preset`` with the
    persisted ``model.arch_overrides``) on ``device``, bf16 compute, its
    weights left for ``load_student_weights`` to fill."""
    from basd_tpu_torch.models.registry import create_model

    ov = config.model.arch_overrides
    ov = ov.to_dict() if hasattr(ov, "to_dict") else dict(ov or {})
    bundle = create_model(
        config.model.student_preset, img_size=config.model.vit.img_size,
        num_classes=config.model.num_classes, arch_overrides=ov or None,
        dtype=torch.bfloat16,
    )
    bundle.module.to(device).eval()
    return bundle


def load_student_weights(module: torch.nn.Module, path: str) -> int:
    """Load a ``.pth`` export, or the trainer's weights file (``path`` +
    ``.pt``, ``.meta.json``), into ``module`` strictly; returns the epoch
    (-1 when unrecorded)."""
    if str(path).endswith(".pth"):
        sd, epoch = port.load_state_dict(path)
    else:
        sd, epoch = ckpt.load_weights(path, map_location="cpu")
    module.load_state_dict(sd, strict=True)
    return epoch


def main(argv: list[str] | None = None,
         device: str | torch.device = "cuda") -> Path:
    from basd_tpu_torch.config import compose, register_resolvers
    from basd_tpu_torch.train import _CONFIG_DIR, resolve_device

    device = resolve_device(device)
    register_resolvers()
    config = compose(_CONFIG_DIR,
                     overrides=list(sys.argv[1:] if argv is None else argv))
    out_path = config.get("export", {}).get("path", "")
    if not out_path:
        raise SystemExit("pass +export.path=student.pth")
    if not config.checkpoint.path:
        raise SystemExit("checkpoint.path is required for the export")
    bundle = build_student(config, device)
    epoch = load_student_weights(bundle.module, config.checkpoint.path)
    n = save_torch_checkpoint(out_path, bundle.module.state_dict(), epoch)
    print(f"exported path={out_path} tensors={n} epoch={epoch}")
    return Path(out_path)


if __name__ == "__main__":
    main()
