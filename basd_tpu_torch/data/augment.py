"""Device-side image augmentation (counterpart of
``basd_tpu/data/augment.py``).

The host ships one (B, R, R, 3) uint8 canvas per batch; both views, the 14
stratified TrivialAugmentWide ops and MixUp/CutMix are computed on the
device:

- clean view: center crop S + teacher-stats normalise;
- augmented view: RandomResizedCrop (+ folded horizontal flip) -> TAW ->
  dataset-stats normalise;
- MixUp/CutMix on the augmented view only.

Each random draw is separate from its application: ``draw_train_views`` /
``draw_mixup`` draw from an explicit ``torch.Generator``; the application
functions take the draws, so tests can inject the JAX package's. The TAW
geometric ops are per-line integer shifts (``augment.py:295-391``), applied
by K9 (``kernels.geom_shift.geom_shift3``, the big rotations' pre-flip
folded in) once over the batch's whole geometric slice: the kernel on a
CUDA tensor, its plain flip and three-pass gather chain on a CPU tensor.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from basd_tpu_torch.kernels.geom_shift import geom_shift3

_NUM_BINS = 31
_NUM_OPS = 14
_F32_EPS = float(np.finfo(np.float32).eps)
_RRC_SCALE = (0.08, 1.0)
_RRC_RATIO = (3.0 / 4.0, 4.0 / 3.0)


def _taw_magnitudes():
    """TrivialAugmentWide magnitude table (torchvision v2, 31 bins)."""
    bins = np.arange(_NUM_BINS, dtype=np.float32)
    lin = lambda hi: np.linspace(0.0, hi, _NUM_BINS, dtype=np.float32)  # noqa: E731
    mags = np.zeros((_NUM_OPS, _NUM_BINS), np.float32)
    signed = np.zeros((_NUM_OPS,), np.float32)
    for i, hi in ((1, 0.99), (2, 0.99), (3, 32.0), (4, 32.0), (5, 135.0),
                  (6, 0.99), (7, 0.99), (8, 0.99), (9, 0.99)):
        mags[i] = lin(hi)
        signed[i] = 1
    mags[10] = 8.0 - np.round(bins / ((_NUM_BINS - 1) / 6.0))
    mags[11] = np.linspace(255.0, 0.0, _NUM_BINS, dtype=np.float32)
    return mags, signed


TAW_MAGS, TAW_SIGNED = _taw_magnitudes()


def op_bounds(b: int) -> list[int]:
    """Position block of each TAW op in a stratified batch of ``b``."""
    return [round(o * b / _NUM_OPS) for o in range(_NUM_OPS + 1)]


def position_ops(b: int) -> np.ndarray:
    bounds = op_bounds(b)
    return np.concatenate(
        [np.full(bounds[o + 1] - bounds[o], o) for o in range(_NUM_OPS)]
    ).astype(np.int64)


# -- draws -----------------------------------------------------------------


@dataclass
class TrainViewDraws:
    """Random draws of ``make_train_views`` for a batch of B.

    u_area, logr: (B, 10) RandomResizedCrop attempts; u_ij: (B, 2) crop
    offsets; flip: (B,) bool; perm: (B,) TAW stratification permutation;
    mag_idx: (B,) magnitude bins and sign: (B,) bool sign flips, both
    indexed by position in the permuted batch.
    """

    u_area: torch.Tensor
    logr: torch.Tensor
    u_ij: torch.Tensor
    flip: torch.Tensor
    perm: torch.Tensor
    mag_idx: torch.Tensor
    sign: torch.Tensor


@dataclass
class MixDraws:
    """MixUp/CutMix draws: use_mixup (bool), lam in [0, 1), box centre."""

    use_mixup: torch.Tensor
    lam: torch.Tensor
    r_y: torch.Tensor
    r_x: torch.Tensor


def draw_train_views(generator: torch.Generator, b: int,
                     device: torch.device) -> TrainViewDraws:
    def uni(shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=generator,
                                           device=device)

    return TrainViewDraws(
        u_area=uni((b, 10), *_RRC_SCALE),
        logr=uni((b, 10), math.log(_RRC_RATIO[0]), math.log(_RRC_RATIO[1])),
        u_ij=uni((b, 2)),
        flip=uni((b,)) < 0.5,
        perm=torch.randperm(b, generator=generator, device=device),
        mag_idx=torch.randint(0, _NUM_BINS, (b,), generator=generator,
                              device=device),
        sign=uni((b,)) < 0.5,
    )


def draw_mixup(generator: torch.Generator, size: int,
               device: torch.device) -> MixDraws:
    """alpha = 1.0 (the reference's): Beta(1, 1) is Uniform(0, 1)."""
    def uni():
        return torch.rand((), generator=generator, device=device)

    return MixDraws(
        use_mixup=uni() < 0.5,
        lam=uni(),
        r_y=torch.randint(0, size, (), generator=generator, device=device),
        r_x=torch.randint(0, size, (), generator=generator, device=device),
    )


# -- RandomResizedCrop -----------------------------------------------------


def rrc_boxes(u_area, logr, u_ij, h: int, w: int):
    """torchvision ``RandomResizedCrop.get_params`` from its draws: the
    first of 10 valid attempts, else the centred fallback. Returns
    (top, left, height, width), each (B,) f32."""
    area = float(h * w)
    target_area = area * u_area
    aspect = torch.exp(logr)
    ws = torch.round(torch.sqrt(target_area * aspect))
    hs = torch.round(torch.sqrt(target_area / aspect))
    valid = (ws > 0) & (ws <= w) & (hs > 0) & (hs <= h)
    first = valid.to(torch.int32).argmax(-1, keepdim=True)
    any_valid = valid.any(-1)
    cw = ws.gather(-1, first)[:, 0]
    ch = hs.gather(-1, first)[:, 0]
    top = torch.floor(u_ij[:, 0] * (h - ch + 1.0))
    left = torch.floor(u_ij[:, 1] * (w - cw + 1.0))
    in_ratio = w / h
    if in_ratio < _RRC_RATIO[0]:
        fw, fh = float(w), float(round(w / _RRC_RATIO[0]))
    elif in_ratio > _RRC_RATIO[1]:
        fw, fh = float(round(h * _RRC_RATIO[1])), float(h)
    else:
        fw, fh = float(w), float(h)
    ftop, fleft = float(round((h - fh) / 2.0)), float(round((w - fw) / 2.0))

    def pick(a, fallback):
        return torch.where(any_valid, a, torch.full_like(a, fallback))

    return pick(top, ftop), pick(left, fleft), pick(ch, fh), pick(cw, fw)


def _resample_weight_mat(in_size: int, out_size: int, scale, translation):
    """(B, in, out) triangle-kernel antialiased resample weights, per image
    (``augment.py:_resample_weight_mat``, with the |scale| antialias fix
    that makes a folded flip exact)."""
    dev = scale.device
    inv_scale = 1.0 / scale
    kernel_scale = torch.clamp(inv_scale.abs(), min=1.0)
    sample_f = (
        (torch.arange(out_size, dtype=torch.float32, device=dev) + 0.5)
        * inv_scale[:, None]
        - (translation * inv_scale)[:, None]
        - 0.5
    )
    x = (sample_f[:, None, :]
         - torch.arange(in_size, dtype=torch.float32, device=dev)[None, :, None]
         ).abs() / kernel_scale[:, None, None]
    weights = torch.clamp(1.0 - x, min=0.0)
    total = weights.sum(1, keepdim=True)
    weights = torch.where(
        total.abs() > 1000.0 * _F32_EPS,
        weights / torch.where(total != 0.0, total, torch.ones_like(total)),
        torch.zeros_like(weights),
    )
    in_bounds = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(in_bounds[:, None, :], weights, torch.zeros_like(weights))


def random_resized_crop(imgs: torch.Tensor, boxes, flip: torch.Tensor,
                        out_size: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, S, S, C) f32: bilinear antialiased resample of
    each image's crop box as two weight-matrix contractions, with the
    horizontal flip folded in (scale_x -> -scale_x)."""
    b, h, w, c = imgs.shape
    top, left, ch, cw = boxes
    scale_y = out_size / ch
    scale_x = out_size / cw
    tx = torch.where(flip, out_size + left * scale_x, -left * scale_x)
    sign = torch.where(flip, -1.0, 1.0)
    wy = _resample_weight_mat(h, out_size, scale_y, -top * scale_y)
    wx = _resample_weight_mat(w, out_size, sign * scale_x, tx)
    x = imgs.float().reshape(b, h, w * c)
    tmp = torch.matmul(wy.transpose(1, 2), x).reshape(b, out_size, w, c)
    tmp = tmp.permute(0, 1, 3, 2).reshape(b, out_size * c, w)
    out = torch.matmul(tmp, wx).reshape(b, out_size, c, out_size)
    return out.permute(0, 1, 3, 2)


# -- TrivialAugmentWide ops (PIL semantics, uint8 in and out) --------------


def _q(p: torch.Tensor) -> torch.Tensor:
    """PIL quantisation: round, clip to [0, 255], uint8."""
    return torch.round(torch.clamp(p, 0.0, 255.0)).to(torch.uint8)


def _gray(img: torch.Tensor) -> torch.Tensor:
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    return 0.299 * r + 0.587 * g + 0.114 * b


def geom_shifts(op: torch.Tensor, mag: torch.Tensor, h: int, w: int):
    """Per-line integer shifts of the five geometric TAW ops (1 ShearX,
    2 ShearY, 3 TranslateX, 4 TranslateY, 5 Rotate): rows r1 (G, H), cols
    r2 (G, W), rows r3 (G, H); rotation by the 3-shear decomposition, with
    ``big`` (G,) marking the |angle| > 90 images that take a 180-degree
    pre-flip. op, mag: (G,). Returns (big, r1, r2, r3), the shifts int32."""
    dev = mag.device
    ys = torch.arange(h, dtype=torch.float32, device=dev) - (h - 1) * 0.5
    xs = torch.arange(w, dtype=torch.float32, device=dev) - (w - 1) * 0.5
    rad = mag * (math.pi / 180.0)
    big = (op == 5) & (mag.abs() > 90.0)
    rad_eff = torch.where(big, rad - torch.sign(mag) * math.pi, rad)
    a_rot = -torch.tan(rad_eff / 2.0)
    b_rot = torch.sin(rad_eff)
    zero = torch.zeros_like(mag)
    is_rot = op == 5
    coef1 = torch.where(op == 1, -mag, torch.where(is_rot, a_rot, zero))
    t1 = torch.where(op == 3, mag, zero)
    r1 = -torch.round(coef1[:, None] * ys[None, :] - t1[:, None]).to(torch.int32)
    coef2 = torch.where(op == 2, -mag, torch.where(is_rot, b_rot, zero))
    t2 = torch.where(op == 4, mag, zero)
    r2 = -torch.round(coef2[:, None] * xs[None, :] - t2[:, None]).to(torch.int32)
    coef3 = torch.where(is_rot, a_rot, zero)
    r3 = -torch.round(coef3[:, None] * ys[None, :]).to(torch.int32)
    return big, r1, r2, r3


def geom_three_pass(x: torch.Tensor, op: torch.Tensor, mag: torch.Tensor):
    """The five geometric TAW ops as per-line integer shifts (rows, cols,
    rows; ``geom_shifts``) applied by one K9 launch, which reads the big
    rotations' images flipped. x: (G, H, W, C), copied where it is not
    contiguous (a crop's output is a permuted view); op, mag: (G,)."""
    big, r1, r2, r3 = geom_shifts(op, mag, x.shape[1], x.shape[2])
    return geom_shift3(x.contiguous(), r1, r2, r3, big)


def _sharpness(xs: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    g, h, w, c = xs.shape
    kernel = torch.tensor([[1.0, 1.0, 1.0], [1.0, 5.0, 1.0], [1.0, 1.0, 1.0]],
                          device=xs.device) / 13.0
    blurred = F.conv2d(xs.permute(0, 3, 1, 2), kernel.expand(c, 1, 3, 3),
                       padding=1, groups=c).permute(0, 2, 3, 1)
    blurred = torch.clamp(torch.round(blurred), 0, 255)
    yy = torch.arange(h, device=xs.device)[:, None]
    xx = torch.arange(w, device=xs.device)[None, :]
    border = ((yy == 0) | (yy == h - 1) | (xx == 0) | (xx == w - 1))
    blurred = torch.where(border[None, :, :, None], xs, blurred)
    return _q(blurred + f * (xs - blurred))


def batch_equalize(imgs: torch.Tensor) -> torch.Tensor:
    """Per-image, per-channel histogram equalisation (torchvision
    ``_scale_channel`` semantics) of a uint8-valued (G, H, W, C) batch;
    returns f32 integer values."""
    g, h, w, c = imgs.shape
    q = torch.clamp(torch.round(imgs.float()), 0, 255).long()
    flat = q.reshape(g, h * w, c).transpose(1, 2)  # (G, C, P)
    hist = torch.zeros((g, c, 256), dtype=torch.long, device=imgs.device)
    hist.scatter_add_(2, flat, torch.ones_like(flat))
    idx = torch.arange(256, device=imgs.device)
    last_nz = torch.where(hist > 0, idx, -1).amax(-1)
    last_count = hist.gather(-1, last_nz.clamp(min=0)[..., None])[..., 0]
    step = torch.div(hist.sum(-1) - last_count, 255, rounding_mode="floor")
    cum = hist.cumsum(-1)
    lut = torch.div(cum + torch.div(step, 2, rounding_mode="floor")[..., None],
                    step.clamp(min=1)[..., None], rounding_mode="floor")
    lut = torch.clamp(torch.cat([torch.zeros_like(lut[..., :1]),
                                 lut[..., :-1]], -1), 0, 255)
    eq = lut.gather(-1, flat).transpose(1, 2).reshape(g, h, w, c).float()
    no_eq = step == 0  # (G, C)
    return torch.where(no_eq[:, None, None, :], imgs.float(), eq)


def taw_apply(x: torch.Tensor, op: int, mag: torch.Tensor) -> torch.Tensor:
    """Apply TAW op ``op`` to a uint8 (G, H, W, C) slice with per-image
    signed magnitudes ``mag`` (G,); uint8 out."""
    if op == 0:
        return x
    if 1 <= op <= 5:
        return geom_three_pass(x, torch.full_like(mag, op, dtype=torch.long),
                               mag)
    f = (1.0 + mag)[:, None, None, None]
    xs = x.float()
    if op == 6:
        return _q(xs * f)
    if op == 7:
        gray = _gray(xs)[..., None]
        return _q(gray + f * (xs - gray))
    if op == 8:
        mean_gray = torch.round(_gray(xs)).mean(dim=(1, 2))[:, None, None, None]
        return _q(mean_gray + f * (xs - mean_gray))
    if op == 9:
        return _sharpness(xs, f)
    if op == 10:
        shift = (8.0 - mag).to(torch.int32)[:, None, None, None]
        qi = x.to(torch.int32)
        return ((qi >> shift) << shift).to(torch.uint8)
    if op == 11:
        return torch.where(xs >= mag[:, None, None, None], 255 - x, x)
    if op == 12:
        lo = x.amin(dim=(1, 2), keepdim=True)
        hi = x.amax(dim=(1, 2), keepdim=True)
        scale = 255.0 / torch.clamp((hi - lo).float(), min=1e-5)
        return torch.where(hi > lo, _q((x - lo).float() * scale), x)
    if op == 13:
        return _q(batch_equalize(x))
    raise ValueError(f"unknown TAW op {op}")


def trivial_augment_wide_stratified(imgs: torch.Tensor, perm: torch.Tensor,
                                    mag_idx: torch.Tensor, sign: torch.Tensor,
                                    rows: slice | None = None):
    """Stratified batched TrivialAugmentWide: ``perm`` assigns the images
    to 14 contiguous position blocks, one per op (static slices); magnitude
    bins and signs are drawn per position. Ops 1-5 run as one geometric
    slice (one K9 launch), as the reference does (``augment.py:533-539``).
    uint8 in and out.

    ``rows``: ``imgs`` holds only these rows of the batch that the draws
    were made for (a data-parallel rank's shard). Each image gets the op
    and magnitude of its position in the whole batch; the shard's images
    are grouped by op in position order, so the shard's geometric images
    are still one slice."""
    b = perm.shape[0]
    if imgs.dtype != torch.uint8:
        imgs = _q(imgs)
    dev = imgs.device
    inv = torch.argsort(perm)
    pos_op = torch.as_tensor(position_ops(b), device=dev)
    bounds = op_bounds(b)
    if rows is None:
        order, unorder = perm, inv
    else:
        # the shard's images sorted by position; blocks cut where the
        # whole batch's blocks are (one host read of the cut points)
        pos = inv[rows]
        order = torch.argsort(pos)
        unorder = torch.argsort(order)
        pos = pos[order]
        pos_op, mag_idx, sign = pos_op[pos], mag_idx[pos], sign[pos]
        bounds = torch.searchsorted(
            pos, torch.as_tensor(bounds, device=dev)).tolist()
    x = imgs[order]
    mags = torch.as_tensor(TAW_MAGS, device=dev)[pos_op, mag_idx]
    signed = torch.as_tensor(TAW_SIGNED, device=dev)[pos_op] > 0
    mag = mags * torch.where(signed & sign, -1.0, 1.0)
    geo = slice(bounds[1], bounds[6])
    parts = [x[:bounds[1]]]
    if bounds[6] > bounds[1]:
        parts.append(geom_three_pass(x[geo], pos_op[geo], mag[geo]))
    parts += [taw_apply(x[bounds[o]:bounds[o + 1]], o,
                        mag[bounds[o]:bounds[o + 1]])
              for o in range(6, _NUM_OPS) if bounds[o + 1] > bounds[o]]
    return torch.cat(parts, 0)[unorder]


# -- views -----------------------------------------------------------------


def center_crop(img: torch.Tensor, out_size: int) -> torch.Tensor:
    h, w = img.shape[-3], img.shape[-2]
    top = (h - out_size) // 2
    left = (w - out_size) // 2
    return img[..., top:top + out_size, left:left + out_size, :]


def normalize(img01: torch.Tensor, mean, std) -> torch.Tensor:
    mean = torch.tensor(mean, dtype=torch.float32, device=img01.device)
    std = torch.tensor(std, dtype=torch.float32, device=img01.device)
    return (img01 - mean) / std


def make_train_views(draws: TrainViewDraws, images_u8: torch.Tensor,
                     out_size: int, train_stats: tuple, teacher_stats: tuple,
                     rows: slice | None = None):
    """uint8 (B, R, R, 3) canvas -> (clean, augmented) f32 views.
    ``rows``: ``images_u8`` holds only these rows of the draws' batch."""
    clean = center_crop(images_u8, out_size).float() / 255.0
    clean = normalize(clean, *teacher_stats)
    _, h, w, _ = images_u8.shape
    r = slice(None) if rows is None else rows
    boxes = rrc_boxes(draws.u_area[r], draws.logr[r], draws.u_ij[r], h, w)
    cropped = random_resized_crop(images_u8, boxes, draws.flip[r], out_size)
    augd = trivial_augment_wide_stratified(cropped, draws.perm, draws.mag_idx,
                                           draws.sign, rows)
    augd = normalize(augd.float() / 255.0, *train_stats)
    return clean, augd


def _shard_roll(x: torch.Tensor, num_shards: int) -> torch.Tensor:
    """Roll by one within each of ``num_shards`` equal row blocks."""
    if num_shards <= 1:
        return torch.roll(x, 1, 0)
    grouped = x.reshape((num_shards, x.shape[0] // num_shards) + x.shape[1:])
    return torch.roll(grouped, 1, 1).reshape(x.shape)


def mixup_cutmix(draws: MixDraws, images: torch.Tensor, labels: torch.Tensor,
                 num_classes: int, num_shards: int = 1):
    """RandomChoice([MixUp, CutMix]) with one lambda per batch; the partner
    is the batch rolled by one, within each of ``num_shards`` data-parallel
    shards (``augment.py:845-868``: the reference's DDP mixes per process).
    Returns (mixed images, soft targets)."""
    onehot = F.one_hot(labels.long(), num_classes).float()
    rolled_img = _shard_roll(images, num_shards)
    rolled_lab = _shard_roll(onehot, num_shards)
    h, w = images.shape[1], images.shape[2]
    lam = draws.lam.float()
    lam_i = lam.to(images.dtype)
    r_h = torch.sqrt(1.0 - lam) * h
    r_w = torch.sqrt(1.0 - lam) * w
    y1 = torch.clamp(draws.r_y - r_h / 2, 0, h).to(torch.int32)
    y2 = torch.clamp(draws.r_y + r_h / 2, 0, h).to(torch.int32)
    x1 = torch.clamp(draws.r_x - r_w / 2, 0, w).to(torch.int32)
    x2 = torch.clamp(draws.r_x + r_w / 2, 0, w).to(torch.int32)
    yy = torch.arange(h, device=images.device)[:, None]
    xx = torch.arange(w, device=images.device)[None, :]
    box = ((yy >= y1) & (yy < y2) & (xx >= x1) & (xx < x2))[None, :, :, None]
    box_f = box.to(images.dtype)
    lam_adj = 1.0 - ((y2 - y1) * (x2 - x1)) / (h * w)
    c_base = torch.where(draws.use_mixup, lam_i, 1.0 - box_f)
    c_roll = torch.where(draws.use_mixup, 1.0 - lam_i, box_f)
    mixed = c_base * images + c_roll * rolled_img
    lam_eff = torch.where(draws.use_mixup, lam_i.float(), lam_adj.float())
    targets = lam_eff * onehot + (1.0 - lam_eff) * rolled_lab
    return mixed, targets


def make_eval_view(images_u8: torch.Tensor, out_size: int, stats: tuple):
    x = center_crop(images_u8, out_size).float() / 255.0
    return normalize(x, *stats)
