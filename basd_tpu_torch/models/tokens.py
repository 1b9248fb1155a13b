"""Packed per-layer token collections (counterpart of
``basd_tpu/models/tokens.py``).

The frozen teacher writes every layer's output into ONE flat (L*B*N, D)
buffer; ``PackedTokens`` views it as (L, B*N, D), rows ordered (b, n), plus
a small (L, B, D) slab of CLS rows collected beside it. Consumers that need
patch-only statistics subtract the CLS slab's contribution or zero-weight
the CLS row (see ``losses.selector`` and ``losses.combined``);
``to_dense()`` recovers the reference-shaped stripped stack off the hot
path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class PackedTokens:
    """Flat per-layer token collection.

    Attributes:
        flat: (L, B*N, D) tokens of all L layers, rows ordered (b, n).
        cls: (L, B, D) per-layer CLS rows, or None without a CLS token.
        batch: B.
        num_tokens: N including the CLS row when present.
        has_cls: whether row 0 of every (b, ...) group is a CLS token.
    """

    flat: torch.Tensor
    cls: Optional[torch.Tensor]
    batch: int
    num_tokens: int
    has_cls: bool

    @property
    def num_patch_tokens(self) -> int:
        return self.num_tokens - 1 if self.has_cls else self.num_tokens

    @property
    def num_layers(self) -> int:
        return self.flat.shape[0]

    @property
    def dim(self) -> int:
        return self.flat.shape[-1]

    def to_dense(self) -> torch.Tensor:
        """Reference-shaped (L, B, N_patch, D) stack, CLS stripped."""
        l, _, d = self.flat.shape
        x = self.flat.reshape(l, self.batch, self.num_tokens, d)
        return x[:, :, 1:, :] if self.has_cls else x


def pack_dense(full: torch.Tensor, *, has_cls: bool) -> PackedTokens:
    """PackedTokens from a dense (L, B, N, D) stack INCLUDING the CLS row."""
    l, b, n, d = full.shape
    return PackedTokens(
        flat=full.reshape(l, b * n, d),
        cls=full[:, :, 0, :] if has_cls else None,
        batch=b,
        num_tokens=n,
        has_cls=has_cls,
    )
