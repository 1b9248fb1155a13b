"""Marchenko-Pastur rank (counterpart of ``basd_tpu/ops/mp_rank.py``).

Covariance ``X^T X / M`` (or the Gram ``X X^T / M`` when M < D), sigma^2 =
the torch-style median eigenvalue (lower middle element), rank = count of
eigenvalues above ``sigma^2 (1 + sqrt(D / M))^2``.
"""

from __future__ import annotations

import torch

from basd_tpu_torch.ops.linalg import eigvalsh_only


def marchenko_pastur_rank(features: torch.Tensor,
                          impl: str = "xla") -> torch.Tensor:
    """MP rank of ``features`` (..., M, D) -> (...,) int32; ``impl`` picks
    the eigensolver (``ops.linalg._eigh_impl``)."""
    m, d = features.shape[-2], features.shape[-1]
    q = d / m
    f32 = features.float()
    ft = f32.transpose(-1, -2)
    cov = (torch.matmul(ft, f32) if m >= d else torch.matmul(f32, ft)) / m
    eigvals = eigvalsh_only(cov, impl)  # ascending
    sigma2 = eigvals[..., (eigvals.shape[-1] - 1) // 2]
    lambda_plus = sigma2 * (1.0 + q ** 0.5) ** 2
    return (eigvals > lambda_plus[..., None]).sum(-1).to(torch.int32)
