"""Smoothed cross-entropy and UW-SO weighting (counterpart of
``basd_tpu/ops/losses.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

_F32_EPS = float(torch.finfo(torch.float32).eps)


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  label_smoothing: float = 0.0) -> torch.Tensor:
    """``nn.CrossEntropyLoss`` semantics, mean reduction; ``targets`` are
    (B,) class ids or (B, C) class probabilities (MixUp/CutMix)."""
    num_classes = logits.shape[-1]
    logits = logits.float()
    if targets.dim() == logits.dim() - 1:
        targets = F.one_hot(targets.long(), num_classes).float()
    else:
        targets = targets.float()
    if label_smoothing:
        targets = targets * (1.0 - label_smoothing) + label_smoothing / num_classes
    logp = torch.log_softmax(logits, dim=-1)
    return -(targets * logp).sum(-1).mean()


def uwso_weights(losses: torch.Tensor) -> torch.Tensor:
    """UW-SO inverse-loss weights over detached losses."""
    inv = 1.0 / torch.clamp(losses.detach().float(), min=_F32_EPS)
    return inv / inv.sum()


def uwso_combine(losses: torch.Tensor) -> torch.Tensor:
    """Weighted sum of losses with UW-SO weights (weights carry no grad)."""
    return (uwso_weights(losses) * losses).sum()
