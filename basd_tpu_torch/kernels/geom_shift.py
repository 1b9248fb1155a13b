"""K9: the three integer per-line shifts of the TrivialAugmentWide
geometric ops (shear x/y, translate x/y, rotate by three shears), with the
big rotations' 180-degree pre-flip folded in, in CUDA
(``csrc/geom_shift.cu``).

Replaces ``basd_tpu/ops/pallas/geom_shift.py:geom_shift3``
(``_geom_kernel``): rows by r1, then columns by r2, then rows by r3, each
with zero fill::

    pass 1: out[g, y, x] = in[g, y, x - r1[g, y]]
    pass 2: out[g, y, x] = in[g, y - r2[g, x], x]
    pass 3: out[g, y, x] = in[g, y, x - r3[g, y]]

where ``in`` is image g flipped in both axes when ``big[g]`` is set (the
reference flips in XLA before its kernel, ``augment.py:352-354``). Called
without ``big``, it is exactly the TPU kernel's function.

The kernel composes the three passes backwards into one source pixel per
output pixel and reads it from the image held in a CTA's shared memory
(variant ``smem``), or from device memory where the image does not fit
(variant ``global``, e.g. 320 px); ``geom_shift3_variant`` picks it from
(H, W, C, element size) alone, and ``geom_shift3.variants`` counts the
launches of each. ``geom_shift3_split`` spreads an image's output rows over
several CTAs so that a small batch still fills the card. The source note in
``csrc/geom_shift.cu`` gives the bound and the design.

``geom_shift3_plain`` is the flip and the three-pass gather chain in plain
PyTorch, taken for CPU tensors.
"""

from __future__ import annotations

import functools

import torch

from basd_tpu_torch.kernels import _build

# mirrored from csrc/geom_shift.cu
_WARPS = 32
_CHUNK = 224  # pixels of a row a warp stages at once (7 segments of 32)
_SMEM_LIMIT = 232448  # a block's dynamic shared memory on sm_90
_MAX_SPLIT = 8
_VARIANTS = {"smem": 0, "global": 1}


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


def geom_shift3_plain(x, r1, r2, r3, big=None):
    """The 180-degree flip of the ``big`` images (G,) bool, if given, then
    rows(r1) -> cols(r2) -> rows(r3), three gather passes."""
    if big is not None:
        x = torch.where(big[:, None, None, None], x.flip(1, 2), x)
    return shift_rows(shift_cols(shift_rows(x, r1), r2), r3)


def smem_bytes(h: int, w: int, c: int, esize: int, image_rows: int) -> int:
    """A CTA's shared memory (``csrc/geom_shift.cu:smem_bytes``): the
    mbarrier and the tables, each warp's staging of a chunk of 224 pixels,
    16 bytes of alignment slack and ``image_rows`` rows of the image."""
    def round16(v):
        return (v + 15) // 16 * 16

    image_off = (round16(16 + 4 * (2 * h + w))
                 + _WARPS * round16(_CHUNK * c * esize))
    return image_off + 16 + image_rows * w * c * esize


def geom_shift3_variant(h: int, w: int, c: int, esize: int) -> str:
    """``smem`` where a whole (h, w, c) image of ``esize``-byte elements
    fits one CTA's shared memory beside its tables and staging, else
    ``global``."""
    return "smem" if smem_bytes(h, w, c, esize, h) <= _SMEM_LIMIT else "global"


def geom_shift3_split(g: int, sms: int) -> int:
    """CTAs per image: as many as one wave of ``sms`` CTAs allows, 1 to 8
    (at 46 images on 132 SMs, 2; at 128, 1)."""
    return max(1, min(_MAX_SPLIT, sms // max(g, 1)))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_table(name: str, r: torch.Tensor, shape: tuple, x: torch.Tensor):
    if tuple(r.shape) != shape:
        raise ValueError(f"geom_shift3: {name} {tuple(r.shape)} does not match "
                         f"images {tuple(x.shape)}")
    if r.device != x.device or not r.is_contiguous():
        raise ValueError(f"geom_shift3: {name} must be contiguous on {x.device}")


def geom_shift3(x: torch.Tensor, r1: torch.Tensor, r2: torch.Tensor,
                r3: torch.Tensor, big: torch.Tensor | None = None, *,
                split: int | None = None,
                variant: str | None = None) -> torch.Tensor:
    """K9: the 180-degree flip of the ``big`` images, then rows(r1) ->
    cols(r2) -> rows(r3) integer line shifts with zero fill.

    x: (G, H, W, C) image batch of any dtype of 1, 2, 4 or 8 bytes; r1, r3:
    (G, H) and r2: (G, W) int32 shifts; big: (G,) bool or None. Returns
    (G, H, W, C) in x.dtype. ``split`` (CTAs per image, 1 to H) and
    ``variant`` override ``geom_shift3_split`` and ``geom_shift3_variant``
    (for sweeps; ``smem`` where the image does not fit raises).
    """
    if x.device.type == "cpu":
        return geom_shift3_plain(x, r1, r2, r3, big)
    if x.device.type != "cuda":
        raise ValueError(f"geom_shift3: unsupported device {x.device}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"geom_shift3: x must be a contiguous (G, H, W, C) "
                         f"tensor, got {tuple(x.shape)}")
    g, h, w, c = x.shape
    esize = x.element_size()
    if esize not in (1, 2, 4, 8):
        raise ValueError(f"geom_shift3: {x.dtype} is not 1, 2, 4 or 8 bytes")
    for name, r, shape in (("r1", r1, (g, h)), ("r2", r2, (g, w)),
                           ("r3", r3, (g, h))):
        _check_table(name, r, shape, x)
        if r.dtype != torch.int32:
            raise ValueError(f"geom_shift3: {name} must be int32, got {r.dtype}")
    if big is not None:
        _check_table("big", big, (g,), x)
        if big.dtype != torch.bool:
            raise ValueError(f"geom_shift3: big must be bool, got {big.dtype}")
    if g > 65535 or h * w * c >= 2 ** 31:
        raise ValueError(f"geom_shift3: {tuple(x.shape)} exceeds the kernel's "
                         "grid (65535 images) or an image's 2**31 elements")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    if variant is None:
        variant = geom_shift3_variant(h, w, c, esize)
    if split is None:
        split = geom_shift3_split(g, _sm_count(x.device.index
                                               if x.device.index is not None
                                               else torch.cuda.current_device()))
    if not 1 <= split <= h:
        raise ValueError(f"geom_shift3: split {split} not in [1, {h}]")
    _build.call("basd_geom_shift3", x.data_ptr(), r1.data_ptr(), r2.data_ptr(),
                r3.data_ptr(), 0 if big is None else big.data_ptr(),
                out.data_ptr(), g, h, w, c, esize, _VARIANTS[variant], split,
                _build.stream_ptr(x.device))
    geom_shift3.launches += 1
    geom_shift3.variants[variant] += 1
    return out


geom_shift3.launches = 0
# launches by variant
geom_shift3.variants = {"smem": 0, "global": 0}
