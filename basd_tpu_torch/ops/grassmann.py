"""Rank masks and spectrally weighted principal angles (counterpart of
``basd_tpu/ops/grassmann.py``; backends 'gram', 'jacobi' (K8) and 'svd').

Data-dependent MP ranks become static-shape masks: the masked cross-basis
matrix ``diag(m) G diag(m)`` keeps exactly the top-k x top-k block, so its
singular values are the k principal cosines followed by zeros, which carry
zero spectral weight.
"""

from __future__ import annotations

import torch

from basd_tpu_torch.ops.linalg import right_singular_vectors, singular_values

_F32_EPS = float(torch.finfo(torch.float32).eps)


def grassmann_subspace(z: torch.Tensor, backend: str = "gram"):
    """Full PCA basis (..., D, D), columns descending, and singular values
    (..., D) of projected tokens (..., M, D), centred in f32."""
    z = z.float()
    z = z - z.mean(-2, keepdim=True)
    svals, basis = right_singular_vectors(z, backend=backend)
    return basis, svals


def rank_mask(ranks: torch.Tensor, dim: int) -> torch.Tensor:
    """(...,) int ranks -> (..., dim) f32 mask of the top-``rank`` slots."""
    idx = torch.arange(dim, device=ranks.device)
    return (idx < ranks[..., None]).float()


def spectral_grassmann_distance_sq(basis_s, basis_t, spectral_weights, mask,
                                   backend: str = "gram"):
    """``sum(sw * theta^2) / sum(sw)`` over the masked principal angles.

    basis_s, basis_t: (..., D, D) bases (descending directions);
    spectral_weights: (..., D) teacher singular values; mask: (..., D).
    """
    g = torch.matmul(basis_s.transpose(-1, -2), basis_t)
    gm = mask[..., :, None] * g * mask[..., None, :]
    sigma = singular_values(gm, backend=backend)
    theta = torch.arccos(torch.clamp(sigma, max=1.0 - _F32_EPS))
    sw = spectral_weights * mask
    num = (sw * theta * theta).sum(-1)
    den = sw.sum(-1)
    return num / torch.clamp(den, min=_F32_EPS)
