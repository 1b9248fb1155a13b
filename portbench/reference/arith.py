"""The arithmetic the reference runs in: ``Arith('f32')`` is plain float32
(TF32 off on the card); ``Arith('control')`` is the control, one step below
what the configuration states: every product of the ViTs and every rounding
of the polar iteration, which the configuration runs in bfloat16, takes
fp8 (e4m3) operands with a per-tensor scale, and every float32 product of
the loss takes TF32 operands (10 mantissa bits). The roundings are made in
plain PyTorch, so the control reads the same on any device; gradients pass
them straight through. ``Arith('tf32')`` lowers the loss's float32 products
alone to TF32 (the ViTs and the polar iteration in float32): the step a
change to the loss's products alone would take."""

from __future__ import annotations

import torch

_E4M3_MAX = 448.0


def round_e4m3(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to fp8 e4m3 with a per-tensor scale (amax to 448)."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / _E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) rounded to nearest on TF32's 10 mantissa bits."""
    bits = x.detach().float().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def _straight_through(x: torch.Tensor, rounded: torch.Tensor) -> torch.Tensor:
    return x + (rounded - x).detach() if x.requires_grad else rounded


class Arith:
    """``polar_dtype``: round the polar iteration's intermediates to this
    type as the configuration does (bfloat16), where a test holds the
    reference against the program's own arithmetic; None keeps float32."""

    def __init__(self, kind: str = "f32", polar_dtype=None):
        if kind not in ("f32", "control", "tf32"):
            raise ValueError(f"unknown arithmetic {kind!r}")
        self.kind = kind
        self.polar_dtype = polar_dtype

    @property
    def control(self) -> bool:
        return self.kind == "control"

    def vit(self, x: torch.Tensor) -> torch.Tensor:
        """An operand of a ViT product."""
        x = x.float()
        return _straight_through(x, round_e4m3(x)) if self.control else x

    def loss(self, x: torch.Tensor) -> torch.Tensor:
        """An operand of a float32 product of the loss."""
        x = x.float()
        lower = self.kind in ("control", "tf32")
        return _straight_through(x, round_tf32(x)) if lower else x

    def polar(self, x: torch.Tensor) -> torch.Tensor:
        """A rounding point of the polar iteration (bfloat16 in the
        configuration; float32 here, fp8 in the control)."""
        if self.control:
            return round_e4m3(x)
        return x if self.polar_dtype is None else x.to(self.polar_dtype).float()

    def linear(self, x, w, b=None):
        y = torch.matmul(self.vit(x), self.vit(w).t())
        return y if b is None else y + b

    def bmm(self, a, b):
        return torch.matmul(self.vit(a), self.vit(b))

    def mm(self, a, b):
        """A float32 product of the loss."""
        return torch.matmul(self.loss(a), self.loss(b))
