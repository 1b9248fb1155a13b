"""The port's device-side augmentation against the JAX package's, with the
JAX package's random draws injected: uint8-exact where the JAX op is
integer (TrivialAugmentWide), 1e-5 relative where it is float (crops,
views, MixUp/CutMix)."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from basd_tpu.data import augment as jaug
from basd_tpu_torch.data import augment as aug

STATS = ((0.5, 0.45, 0.4), (0.25, 0.22, 0.2))
T_STATS = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))


def _images(b, size, seed):
    """Smooth structure plus noise, uint8, like the synthetic source."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    base = np.stack([np.sin(6 * yy + k) * np.cos(4 * xx - k) for k in range(3)], -1)
    imgs = 128 + 90 * base[None] * rng.uniform(0.3, 1.0, (b, 1, 1, 3))
    imgs = imgs + rng.normal(0, 12, (b, size, size, 3))
    return np.clip(imgs, 0, 255).astype(np.uint8)


def _rrc_draws(key):
    """The draws jax's _rrc_params takes from ``key``."""
    k0, k1, k2 = jax.random.split(key, 3)
    u_area = jax.random.uniform(k0, (10,), minval=0.08, maxval=1.0)
    logr = jax.random.uniform(k1, (10,), minval=jnp.log(3.0 / 4.0),
                              maxval=jnp.log(4.0 / 3.0))
    return u_area, logr, jax.random.uniform(k2, (2,))


def _taw_draws(key, b):
    k_perm, k_mag, k_sign = jax.random.split(key, 3)
    return (jax.random.permutation(k_perm, b),
            jax.random.randint(k_mag, (b,), 0, 31),
            jax.random.bernoulli(k_sign, 0.5, (b,)))


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(a, r, tol=1e-5):
    a, r = np.asarray(a, np.float64), np.asarray(r, np.float64)
    assert a.shape == r.shape
    assert np.abs(a - r).max() <= tol * max(np.abs(r).max(), 1.0)


def test_taw_stratified_all_ops_uint8_exact():
    b = 2 * 14  # two images per op
    imgs = _images(b, 24, 1)
    key = jax.random.PRNGKey(3)
    ref, ops, mags = jaug.trivial_augment_wide_stratified(
        key, jnp.asarray(imgs), return_draws=True)
    perm, mag_idx, sign = _taw_draws(key, b)
    out = aug.trivial_augment_wide_stratified(
        torch.from_numpy(imgs), _t(perm).long(), _t(mag_idx).long(), _t(sign))
    assert out.dtype == torch.uint8
    ref = np.asarray(ref)
    bad = sorted({int(o) for i, o in enumerate(np.asarray(ops))
                  if not np.array_equal(out[i].numpy(), ref[i])})
    assert bad == [], f"TAW ops differ: {bad}"
    assert set(np.asarray(ops).tolist()) == set(range(14))


@pytest.mark.parametrize("flip", [False, True])
def test_random_resized_crop_matches_jax(flip):
    b, r, s = 6, 40, 32
    imgs = _images(b, r, 2)
    keys = jax.random.split(jax.random.PRNGKey(4), b)
    refs, draws = [], []
    for i in range(b):
        refs.append(jaug.random_resized_crop(
            keys[i], jnp.asarray(imgs[i], jnp.float32), s,
            flip=jnp.asarray(flip)))
        draws.append(_rrc_draws(keys[i]))
    u_area, logr, u_ij = (_t(np.stack([np.asarray(d[k]) for d in draws]))
                          for k in range(3))
    boxes = aug.rrc_boxes(u_area, logr, u_ij, r, r)
    out = aug.random_resized_crop(torch.from_numpy(imgs), boxes,
                                  torch.full((b,), flip), s)
    _close(out.numpy(), np.stack([np.asarray(x) for x in refs]))


def test_make_train_views_matches_jax():
    """Whole view pipeline with the JAX draws: the clean view to 1e-5; the
    augmented view exact except at the rare pixels where the crop's f32
    summation order flips a rounding before TAW (one level, scaled by at
    most TAW's enhancement factor < 2, then rounded: <= 3 levels)."""
    b, r, s = 14, 40, 32
    imgs = _images(b, r, 3)
    key = jax.random.PRNGKey(5)
    ref_clean, ref_aug = jaug.make_train_views(key, jnp.asarray(imgs), s,
                                               STATS, T_STATS)
    keys = jax.random.split(key, (b, 2))
    rrc = [_rrc_draws(keys[i, 0]) for i in range(b)]
    flip = np.array([bool(jax.random.bernoulli(keys[i, 1], 0.5)) for i in range(b)])
    perm, mag_idx, sign = _taw_draws(jax.random.fold_in(key, 7), b)
    draws = aug.TrainViewDraws(
        u_area=_t(np.stack([np.asarray(d[0]) for d in rrc])),
        logr=_t(np.stack([np.asarray(d[1]) for d in rrc])),
        u_ij=_t(np.stack([np.asarray(d[2]) for d in rrc])),
        flip=torch.from_numpy(flip), perm=_t(perm).long(),
        mag_idx=_t(mag_idx).long(), sign=_t(sign))
    clean, augd = aug.make_train_views(draws, torch.from_numpy(imgs), s,
                                       STATS, T_STATS)
    _close(clean.numpy(), np.asarray(ref_clean))
    diff = np.abs(augd.numpy() - np.asarray(ref_aug))
    assert diff.max() <= 3.0 / 255.0 / min(STATS[1]) + 1e-5
    assert (diff > 1e-5).mean() <= 1e-3


@pytest.mark.parametrize("seed", range(4))
def test_mixup_cutmix_matches_jax(seed):
    b, s, c = 6, 16, 5
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((b, s, s, 3)).astype(np.float32)
    labels = rng.integers(0, c, b).astype(np.int32)
    key = jax.random.PRNGKey(100 + seed)
    ref_img, ref_tgt = jaug.mixup_cutmix(key, jnp.asarray(images),
                                         jnp.asarray(labels), c)
    k_choice, k_lam, k_box = jax.random.split(key, 3)
    draws = aug.MixDraws(
        use_mixup=_t(jax.random.bernoulli(k_choice, 0.5)),
        lam=_t(jax.random.beta(k_lam, 1.0, 1.0)),
        r_y=_t(jax.random.randint(k_box, (), 0, s)).long(),
        r_x=_t(jax.random.randint(jax.random.fold_in(k_box, 1), (), 0, s)).long())
    img, tgt = aug.mixup_cutmix(draws, torch.from_numpy(images),
                                torch.from_numpy(labels), c)
    _close(img.numpy(), np.asarray(ref_img))
    _close(tgt.numpy(), np.asarray(ref_tgt))


def test_make_eval_view_matches_jax():
    imgs = _images(3, 40, 4)
    ref = jaug.make_eval_view(jnp.asarray(imgs), 32, STATS)
    _close(aug.make_eval_view(torch.from_numpy(imgs), 32, STATS).numpy(),
           np.asarray(ref))


def test_draws_are_valid():
    g = torch.Generator().manual_seed(0)
    d = aug.draw_train_views(g, 28, torch.device("cpu"))
    assert sorted(d.perm.tolist()) == list(range(28))
    assert d.u_area.min() >= 0.08 and d.u_area.max() < 1.0
    assert d.logr.abs().max() <= math.log(4.0 / 3.0) + 1e-6
    assert 0 <= int(d.mag_idx.min()) and int(d.mag_idx.max()) < 31
    m = aug.draw_mixup(g, 32, torch.device("cpu"))
    assert 0.0 <= float(m.lam) < 1.0 and 0 <= int(m.r_y) < 32
