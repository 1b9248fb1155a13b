"""K9: the three integer per-line shifts of the TrivialAugmentWide
geometric ops (shear x/y, translate x/y, rotate by three shears), in
Triton.

Replaces ``basd_tpu/ops/pallas/geom_shift.py:geom_shift3``
(``_geom_kernel``): rows by r1, then columns by r2, then rows by r3, each
with zero fill::

    pass 1: out[g, y, x] = in[g, y, x - r1[g, y]]
    pass 2: out[g, y, x] = in[g, y - r2[g, x], x]
    pass 3: out[g, y, x] = in[g, y, x - r3[g, y]]

What bounds it on the H100: one read and one write of the uint8 image
slab (at B=128, 224 px: 19.3 MB each way, ~12 us at 3.35 TB/s); there is
no arithmetic beyond index math. The TPU kernel keeps a block of planes
in VMEM and runs the three barrel-shift cascades there. This kernel takes
the other option the port allows: ONE launch in which each output pixel
composes the three passes backwards into a single source index (and a
validity bit: zero if any pass filled it), then gathers that one pixel.
Each output pixel costs one gather and the shift tables (a few KB, in
L1/L2) instead of three full passes over the slab, so the slab crosses
device memory once each way, and the result is the same integer data as
the three-pass chain, bit for bit. The "big rotation" 180-degree pre-flip
stays outside, as in ``augment.py:352-354``.

``geom_shift3_plain`` is the three-pass gather chain in plain PyTorch,
taken for CPU tensors.
"""

from __future__ import annotations

import torch

_BLOCK = 1024  # output elements per program
_TRITON: dict = {}


def _kernels() -> dict:
    """Compile-on-first-use Triton kernel (triton imports only here)."""
    if _TRITON:
        return _TRITON
    global triton, tl
    import triton
    import triton.language as tl

    @triton.jit
    def geom_shift3_kernel(x_ptr, r1_ptr, r2_ptr, r3_ptr, o_ptr, total, h, w, c,
                           BLOCK: tl.constexpr):
        offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        live = offs < total
        ch = offs % c
        t = offs // c
        xo = t % w
        t = t // w
        yo = t % h
        g = t // h
        # pass 3 (rows by r3), read back to pass 2's output
        x1 = xo - tl.load(r3_ptr + g * h + yo, mask=live, other=0)
        ok = live & (x1 >= 0) & (x1 < w)
        # pass 2 (columns by r2), read back to pass 1's output
        y2 = yo - tl.load(r2_ptr + g * w + x1, mask=ok, other=0)
        ok = ok & (y2 >= 0) & (y2 < h)
        # pass 1 (rows by r1), read back to the input
        x3 = x1 - tl.load(r1_ptr + g * h + y2, mask=ok, other=0)
        ok = ok & (x3 >= 0) & (x3 < w)
        v = tl.load(x_ptr + ((g * h + y2) * w + x3) * c + ch, mask=ok, other=0)
        tl.store(o_ptr + offs, v, mask=live)

    _TRITON.update(shift3=geom_shift3_kernel)
    return _TRITON


def shift_rows(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """out[g, y, j] = x[g, y, j - r[g, y]], zero fill. x: (G, H, W, C)."""
    g, h, w, c = x.shape
    j = torch.arange(w, device=x.device)
    src = j[None, None, :] - r[:, :, None]  # (G, H, W)
    valid = (src >= 0) & (src < w)
    idx = src.clamp(0, w - 1)[..., None].expand(g, h, w, c)
    out = torch.gather(x, 2, idx)
    return torch.where(valid[..., None], out, torch.zeros_like(out))


def shift_cols(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """out[g, i, x] = x_in[g, i - r[g, x], x], zero fill."""
    g, h, w, c = x.shape
    i = torch.arange(h, device=x.device)
    src = i[None, :, None] - r[:, None, :]  # (G, H, W)
    valid = (src >= 0) & (src < h)
    idx = src.clamp(0, h - 1)[..., None].expand(g, h, w, c)
    out = torch.gather(x, 1, idx)
    return torch.where(valid[..., None], out, torch.zeros_like(out))


def geom_shift3_plain(x, r1, r2, r3):
    """rows(r1) -> cols(r2) -> rows(r3), three gather passes."""
    return shift_rows(shift_cols(shift_rows(x, r1), r2), r3)


def geom_shift3(x: torch.Tensor, r1: torch.Tensor, r2: torch.Tensor,
                r3: torch.Tensor) -> torch.Tensor:
    """K9: rows(r1) -> cols(r2) -> rows(r3) integer line shifts with zero
    fill.

    x: (G, H, W, C) image batch of any dtype; r1, r3: (G, H) and r2:
    (G, W) integer shifts. Returns (G, H, W, C) in x.dtype.
    """
    if x.device.type == "cpu":
        return geom_shift3_plain(x, r1, r2, r3)
    if x.device.type != "cuda":
        raise ValueError(f"geom_shift3: unsupported device {x.device}")
    g, h, w, c = x.shape
    if tuple(r1.shape) != (g, h) or tuple(r2.shape) != (g, w) or tuple(
            r3.shape) != (g, h):
        raise ValueError(
            f"geom_shift3: shifts {tuple(r1.shape)}, {tuple(r2.shape)}, "
            f"{tuple(r3.shape)} do not match images {tuple(x.shape)}")
    r1, r2, r3 = (r.to(device=x.device, dtype=torch.int32).contiguous()
                  for r in (r1, r2, r3))
    x = x.contiguous()
    out = torch.empty_like(x)
    total = x.numel()
    if total >= 2 ** 31:
        raise ValueError("geom_shift3: more than 2**31 elements")
    if total == 0:
        return out
    grid = (-(-total // _BLOCK),)
    _kernels()["shift3"][grid](x, r1, r2, r3, out, total, h, w, c,
                               BLOCK=_BLOCK)
    geom_shift3.launches += 1
    return out


geom_shift3.launches = 0
