"""Eval step and device-side accumulation (counterpart of the
``make_eval_step`` / ``_accum_eval`` / ``_finalize_eval`` part of
``basd_tpu/evaluation/metrics.py``)."""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from basd_tpu_torch.data import augment as aug


def make_eval_step(apply_logits_fn: Callable, *, img_size: int, stats: tuple,
                   valid_indices=None, label_smoothing: float = 0.0):
    """uint8 canvases + labels -> summed top1/top5/CE (one implementation
    for trainer validation and the eval suite). ``apply_logits_fn(x)``
    maps (B, S, S, 3) images to logits."""
    stats = tuple(map(tuple, stats))

    @torch.no_grad()
    def step(images_u8: torch.Tensor, labels: torch.Tensor) -> dict:
        x = aug.make_eval_view(images_u8, img_size, stats)
        logits = apply_logits_fn(x).float()
        if valid_indices is not None:
            logits = logits[:, torch.as_tensor(valid_indices,
                                               device=logits.device)]
        valid = labels >= 0
        num_c = logits.shape[-1]
        onehot = F.one_hot(labels.clamp(min=0).long(), num_c).float()
        if label_smoothing:
            onehot = onehot * (1.0 - label_smoothing) + label_smoothing / num_c
        ce = -(onehot * torch.log_softmax(logits, -1)).sum(-1)
        top5 = logits.topk(min(5, num_c), dim=-1).indices
        return {
            "ce_sum": torch.where(valid, ce, torch.zeros_like(ce)).sum(),
            "top1": ((logits.argmax(-1) == labels) & valid).sum(),
            "top5": ((top5 == labels[:, None]).any(-1) & valid).sum(),
            "count": valid.sum(),
        }

    return step


def accumulate(acc: dict | None, m: dict) -> dict:
    """Device-side running sums: no host transfer per batch."""
    if acc is None:
        return {k: v.clone() for k, v in m.items()}
    for k in acc:
        acc[k] += m[k]
    return acc


def finalize(acc: dict | None) -> dict[str, float]:
    """One host transfer for the whole accumulated dict."""
    if acc is None:
        return {"val_acc": 0.0, "val_acc_top5": 0.0, "loss": 0.0}
    host = {k: v.item() for k, v in acc.items()}
    total = max(int(host["count"]), 1)
    return {
        "val_acc": 100.0 * int(host["top1"]) / total,
        "val_acc_top5": 100.0 * int(host["top5"]) / total,
        "loss": float(host["ce_sum"]) / total,
    }
