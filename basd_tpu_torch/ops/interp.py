"""Parameter-free 1-D linear interpolation along the token axis
(counterpart of ``basd_tpu/ops/interp.py``): a static (target, source)
weight matrix that matches ``F.interpolate(mode='linear',
align_corners=False)``, applied as a matmul."""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=None)
def _interp_matrix_np(src: int, dst: int) -> np.ndarray:
    """(dst, src) matrix W with out = W @ inp, half-pixel linear weights."""
    if src == dst:
        return np.eye(src, dtype=np.float32)
    scale = src / dst
    x = (np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5
    x = np.maximum(x, 0.0)
    i0 = np.minimum(np.floor(x).astype(np.int64), src - 1)
    i1 = np.minimum(i0 + 1, src - 1)
    frac = x - i0
    w = np.zeros((dst, src), dtype=np.float64)
    rows = np.arange(dst)
    np.add.at(w, (rows, i0), 1.0 - frac)
    np.add.at(w, (rows, i1), frac)
    return w.astype(np.float32)


def linear_interp1d(x: torch.Tensor, target_len: int, axis: int = -1):
    """Linearly resample ``x`` along ``axis`` to ``target_len``."""
    axis = axis % x.dim()
    src = x.shape[axis]
    if src == target_len:
        return x
    w = torch.as_tensor(_interp_matrix_np(src, target_len), dtype=x.dtype,
                        device=x.device)
    out = torch.matmul(x.movedim(axis, -1), w.t())
    return out.movedim(-1, axis)


def align_token_count(tokens: torch.Tensor, target_n: int) -> torch.Tensor:
    """Resample (B, N, D) tokens to (B, target_n, D) along the token axis."""
    return linear_interp1d(tokens, target_n, axis=1)
