"""The views of a BASD train step in plain PyTorch: the draws, the clean
teacher view, RandomResizedCrop with the folded flip, the 14 stratified
TrivialAugmentWide ops (the five geometric ones as three per-line integer
shift passes), normalisation, MixUp/CutMix and the stochastic-depth draws.

A frozen copy of the port's plain device augmentation (the torchvision and
PIL semantics that the JAX package restates), so that the reference draws
from a generator seeded as the program's the same numbers in the same
order and applies them by its own code."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

_NUM_BINS = 31
_NUM_OPS = 14
_F32_EPS = float(np.finfo(np.float32).eps)
_RRC_SCALE = (0.08, 1.0)
_RRC_RATIO = (3.0 / 4.0, 4.0 / 3.0)


def _taw_magnitudes():
    bins = np.arange(_NUM_BINS, dtype=np.float32)
    mags = np.zeros((_NUM_OPS, _NUM_BINS), np.float32)
    signed = np.zeros((_NUM_OPS,), np.float32)
    for i, hi in ((1, 0.99), (2, 0.99), (3, 32.0), (4, 32.0), (5, 135.0),
                  (6, 0.99), (7, 0.99), (8, 0.99), (9, 0.99)):
        mags[i] = np.linspace(0.0, hi, _NUM_BINS, dtype=np.float32)
        signed[i] = 1
    mags[10] = 8.0 - np.round(bins / ((_NUM_BINS - 1) / 6.0))
    mags[11] = np.linspace(255.0, 0.0, _NUM_BINS, dtype=np.float32)
    return mags, signed


TAW_MAGS, TAW_SIGNED = _taw_magnitudes()


def op_bounds(b: int) -> list:
    return [round(o * b / _NUM_OPS) for o in range(_NUM_OPS + 1)]


def draw_step(g: torch.Generator, b: int, size: int, depth: int,
              drop_path_rate: float, device) -> dict:
    """One step's draws, in the program's order: crop attempts, offsets,
    flips, the TAW permutation, bins and signs; then MixUp/CutMix; then
    the (depth, 2, B) stochastic-depth keeps."""
    def uni(shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=g, device=device)

    d = {
        "u_area": uni((b, 10), *_RRC_SCALE),
        "logr": uni((b, 10), math.log(_RRC_RATIO[0]), math.log(_RRC_RATIO[1])),
        "u_ij": uni((b, 2)),
        "flip": uni((b,)) < 0.5,
        "perm": torch.randperm(b, generator=g, device=device),
        "mag_idx": torch.randint(0, _NUM_BINS, (b,), generator=g,
                                 device=device),
        "sign": uni((b,)) < 0.5,
    }
    d["use_mixup"] = torch.rand((), generator=g, device=device) < 0.5
    d["lam"] = torch.rand((), generator=g, device=device)
    d["r_y"] = torch.randint(0, size, (), generator=g, device=device)
    d["r_x"] = torch.randint(0, size, (), generator=g, device=device)
    d["keep_rates"] = None
    if drop_path_rate > 0.0:
        rates = np.linspace(0.0, drop_path_rate, depth).astype(np.float32)
        keeps = torch.as_tensor(1.0 - rates, device=device)
        u = torch.rand((depth, 2, b), generator=g, device=device)
        d["drop_masks"] = u < keeps[:, None, None]
        d["keep_rates"] = [float(np.float32(1.0) - r) for r in rates]
    return d


def rrc_boxes(u_area, logr, u_ij, h: int, w: int):
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
    fw, fh = float(w), float(h)  # a square canvas: the ratio is in range
    ftop, fleft = float(round((h - fh) / 2.0)), float(round((w - fw) / 2.0))

    def pick(a, fallback):
        return torch.where(any_valid, a, torch.full_like(a, fallback))

    return pick(top, ftop), pick(left, fleft), pick(ch, fh), pick(cw, fw)


def _resample_weights(in_size: int, out_size: int, scale, translation):
    dev = scale.device
    inv_scale = 1.0 / scale
    kernel_scale = torch.clamp(inv_scale.abs(), min=1.0)
    sample_f = ((torch.arange(out_size, dtype=torch.float32, device=dev) + 0.5)
                * inv_scale[:, None] - (translation * inv_scale)[:, None] - 0.5)
    x = (sample_f[:, None, :] - torch.arange(
        in_size, dtype=torch.float32, device=dev)[None, :, None]
         ).abs() / kernel_scale[:, None, None]
    weights = torch.clamp(1.0 - x, min=0.0)
    total = weights.sum(1, keepdim=True)
    weights = torch.where(
        total.abs() > 1000.0 * _F32_EPS,
        weights / torch.where(total != 0.0, total, torch.ones_like(total)),
        torch.zeros_like(weights))
    in_bounds = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(in_bounds[:, None, :], weights, torch.zeros_like(weights))


def random_resized_crop(imgs, boxes, flip, out_size: int):
    b, h, w, c = imgs.shape
    top, left, ch, cw = boxes
    scale_y = out_size / ch
    scale_x = out_size / cw
    tx = torch.where(flip, out_size + left * scale_x, -left * scale_x)
    sign = torch.where(flip, -1.0, 1.0)
    wy = _resample_weights(h, out_size, scale_y, -top * scale_y)
    wx = _resample_weights(w, out_size, sign * scale_x, tx)
    x = imgs.float().reshape(b, h, w * c)
    tmp = torch.matmul(wy.transpose(1, 2), x).reshape(b, out_size, w, c)
    tmp = tmp.permute(0, 1, 3, 2).reshape(b, out_size * c, w)
    out = torch.matmul(tmp, wx).reshape(b, out_size, c, out_size)
    return out.permute(0, 1, 3, 2)


def _q(p):
    """PIL quantisation: round, clip to [0, 255], uint8."""
    return torch.round(torch.clamp(p, 0.0, 255.0)).to(torch.uint8)


def _gray(img):
    return 0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]


def _shift_rows(x, r):
    g, h, w, c = x.shape
    src = torch.arange(w, device=x.device)[None, None, :] - r[:, :, None]
    valid = (src >= 0) & (src < w)
    out = torch.gather(x, 2, src.clamp(0, w - 1)[..., None].expand(g, h, w, c))
    return torch.where(valid[..., None], out, torch.zeros_like(out))


def _shift_cols(x, r):
    g, h, w, c = x.shape
    src = torch.arange(h, device=x.device)[None, :, None] - r[:, None, :]
    valid = (src >= 0) & (src < h)
    out = torch.gather(x, 1, src.clamp(0, h - 1)[..., None].expand(g, h, w, c))
    return torch.where(valid[..., None], out, torch.zeros_like(out))


def geometric(x, op, mag):
    """Ops 1-5 (shear x/y, translate x/y, rotate by three shears; a
    rotation beyond 90 degrees after a 180-degree flip) as rows, columns,
    rows integer shifts with zero fill."""
    g, h, w, _ = x.shape
    dev = x.device
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
    r1 = -torch.round(coef1[:, None] * ys[None, :] - t1[:, None]).long()
    coef2 = torch.where(op == 2, -mag, torch.where(is_rot, b_rot, zero))
    t2 = torch.where(op == 4, mag, zero)
    r2 = -torch.round(coef2[:, None] * xs[None, :] - t2[:, None]).long()
    r3 = -torch.round(torch.where(is_rot, a_rot, zero)[:, None]
                      * ys[None, :]).long()
    x = torch.where(big[:, None, None, None], x.flip(1, 2), x)
    return _shift_rows(_shift_cols(_shift_rows(x, r1), r2), r3)


def _sharpness(xs, f):
    c = xs.shape[-1]
    h, w = xs.shape[1], xs.shape[2]
    kernel = torch.tensor([[1.0, 1.0, 1.0], [1.0, 5.0, 1.0], [1.0, 1.0, 1.0]],
                          device=xs.device) / 13.0
    blurred = F.conv2d(xs.permute(0, 3, 1, 2), kernel.expand(c, 1, 3, 3),
                       padding=1, groups=c).permute(0, 2, 3, 1)
    blurred = torch.clamp(torch.round(blurred), 0, 255)
    yy = torch.arange(h, device=xs.device)[:, None]
    xx = torch.arange(w, device=xs.device)[None, :]
    border = (yy == 0) | (yy == h - 1) | (xx == 0) | (xx == w - 1)
    blurred = torch.where(border[None, :, :, None], xs, blurred)
    return _q(blurred + f * (xs - blurred))


def _equalize(imgs):
    g, h, w, c = imgs.shape
    q = torch.clamp(torch.round(imgs.float()), 0, 255).long()
    flat = q.reshape(g, h * w, c).transpose(1, 2)
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
    return torch.where((step == 0)[:, None, None, :], imgs.float(), eq)


def _photometric(x, op: int, mag):
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
        return ((x.to(torch.int32) >> shift) << shift).to(torch.uint8)
    if op == 11:
        return torch.where(xs >= mag[:, None, None, None], 255 - x, x)
    if op == 12:
        lo = x.amin(dim=(1, 2), keepdim=True)
        hi = x.amax(dim=(1, 2), keepdim=True)
        scale = 255.0 / torch.clamp((hi - lo).float(), min=1e-5)
        return torch.where(hi > lo, _q((x - lo).float() * scale), x)
    return _q(_equalize(x))


def trivial_augment(imgs, perm, mag_idx, sign):
    """Stratified TrivialAugmentWide on a uint8-quantised batch: position
    blocks of the permuted batch, one op each; uint8 out."""
    b = perm.shape[0]
    imgs = _q(imgs)
    dev = imgs.device
    bounds = op_bounds(b)
    pos_op = torch.as_tensor(np.concatenate(
        [np.full(bounds[o + 1] - bounds[o], o) for o in range(_NUM_OPS)]
    ).astype(np.int64), device=dev)
    x = imgs[perm]
    mags = torch.as_tensor(TAW_MAGS, device=dev)[pos_op, mag_idx]
    signed = torch.as_tensor(TAW_SIGNED, device=dev)[pos_op] > 0
    mag = mags * torch.where(signed & sign, -1.0, 1.0)
    parts = [x[:bounds[1]]]
    if bounds[6] > bounds[1]:
        geo = slice(bounds[1], bounds[6])
        parts.append(geometric(x[geo], pos_op[geo], mag[geo]))
    parts += [_photometric(x[bounds[o]:bounds[o + 1]], o,
                           mag[bounds[o]:bounds[o + 1]])
              for o in range(6, _NUM_OPS) if bounds[o + 1] > bounds[o]]
    return torch.cat(parts, 0)[torch.argsort(perm)]


def normalize(img01, stats):
    mean = torch.tensor(stats[0], dtype=torch.float32, device=img01.device)
    std = torch.tensor(stats[1], dtype=torch.float32, device=img01.device)
    return (img01 - mean) / std


def views(d: dict, images_u8, labels, size: int, train_stats, teacher_stats,
          num_classes: int):
    """(clean teacher view, mixed student view, soft targets), f32."""
    _, h, w, _ = images_u8.shape
    top, left = (h - size) // 2, (w - size) // 2
    clean = normalize(images_u8[:, top:top + size, left:left + size].float()
                      / 255.0, teacher_stats)
    boxes = rrc_boxes(d["u_area"], d["logr"], d["u_ij"], h, w)
    crop = random_resized_crop(images_u8, boxes, d["flip"], size)
    aug = trivial_augment(crop, d["perm"], d["mag_idx"], d["sign"])
    aug = normalize(aug.float() / 255.0, train_stats)

    onehot = F.one_hot(labels.long(), num_classes).float()
    rolled_img = torch.roll(aug, 1, 0)
    rolled_lab = torch.roll(onehot, 1, 0)
    lam = d["lam"].float()
    r_h = torch.sqrt(1.0 - lam) * size
    r_w = torch.sqrt(1.0 - lam) * size
    y1 = torch.clamp(d["r_y"] - r_h / 2, 0, size).to(torch.int32)
    y2 = torch.clamp(d["r_y"] + r_h / 2, 0, size).to(torch.int32)
    x1 = torch.clamp(d["r_x"] - r_w / 2, 0, size).to(torch.int32)
    x2 = torch.clamp(d["r_x"] + r_w / 2, 0, size).to(torch.int32)
    yy = torch.arange(size, device=aug.device)[:, None]
    xx = torch.arange(size, device=aug.device)[None, :]
    box = ((yy >= y1) & (yy < y2) & (xx >= x1) & (xx < x2))[None, :, :, None]
    box = box.float()
    lam_adj = 1.0 - ((y2 - y1) * (x2 - x1)) / (size * size)
    use = d["use_mixup"]
    mixed = (torch.where(use, lam, 1.0 - box) * aug
             + torch.where(use, 1.0 - lam, box) * rolled_img)
    lam_eff = torch.where(use, lam, lam_adj.float())
    targets = lam_eff * onehot + (1.0 - lam_eff) * rolled_lab
    return clean, mixed, targets
