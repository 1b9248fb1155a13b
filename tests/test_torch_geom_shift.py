"""K9 (``kernels/geom_shift.py``, ``csrc/geom_shift.cu``) as far as the CPU
reaches it.

- The port's ``augment.geom_three_pass``, whose K9 call reads the big
  rotations' images flipped (``geom_shift3`` with ``big``; on a CPU tensor
  ``geom_shift3_plain`` with the flag), against the JAX package's
  ``_geom_three_pass`` (``basd_tpu/data/augment.py:337``: the flip in XLA,
  then the three shift passes), bit for bit: every geometric op, rotation
  on both sides of the 90-degree pre-flip, H != W, C in {1, 3}, uint8 and
  float32 (integer pixel values, which the reference's bf16 cascade keeps
  exact). ``tests/test_torch_student_kernels.py`` holds the flag-free
  plain version to ``basd_tpu``'s ``geom_shift3`` in interpret mode.
- One slice of mixed ops (the train step's geometric slice) in one call,
  and the stratified TrivialAugmentWide taking exactly one K9 call for
  ops 1-5, as the reference's ``augment.py:533-539`` does.
- The pure rules of the wrapper: which variant an image takes (shared
  memory or device memory) and how many CTAs an image gets.

``chip_smoke.py``'s kernel phase holds the CUDA kernel to the plain version
on the card, bit for bit.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from basd_tpu_torch.data import augment as aug
from basd_tpu_torch.kernels import geom_shift

RNG = np.random.default_rng(17)
_HI = {1: 0.99, 2: 0.99, 3: 32.0, 4: 32.0, 5: 135.0}


def _mags(op: int, big: bool, g: int) -> np.ndarray:
    """Signed magnitudes of op ``op``; for op 5 all beyond 90 degrees
    (``big``) or all within."""
    lo, hi = (90.5, _HI[op]) if big else (0.0, 90.0 if op == 5 else _HI[op])
    return (RNG.uniform(lo, hi, g) * RNG.choice([-1.0, 1.0], g)).astype(np.float32)


def _images(g, h, w, c, dtype):
    return RNG.integers(0, 256, (g, h, w, c)).astype(dtype)


def _reference(x, ops, mags):
    from basd_tpu.data import augment as jaug

    return np.array(jaug._geom_three_pass(jnp.asarray(x), jnp.asarray(ops),
                                          jnp.asarray(mags)))


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("op,big", [(1, False), (2, False), (3, False),
                                    (4, False), (5, False), (5, True)])
def test_folded_flip_matches_jax_geom_three_pass(op, big, c, dtype):
    g, h, w = 6, 24, 40
    x = _images(g, h, w, c, dtype)
    mags = _mags(op, big, g)
    ops = np.full((g,), op)
    flags = aug.geom_shifts(torch.from_numpy(ops), torch.from_numpy(mags), h, w)[0]
    assert bool(flags.all()) == big and bool(flags.any()) == big
    out = aug.geom_three_pass(torch.from_numpy(x), torch.from_numpy(ops),
                              torch.from_numpy(mags))
    assert out.dtype == torch.from_numpy(x).dtype
    assert np.array_equal(out.numpy(), _reference(x, ops, mags))


@pytest.mark.parametrize("h,w", [(40, 24), (17, 31)])
def test_mixed_geometric_slice_matches_jax(h, w):
    """Ops 1-5 mixed in one slice, big rotations among them: one call."""
    g = 15
    x = _images(g, h, w, 3, np.uint8)
    ops = np.repeat(np.arange(1, 6), 3)
    mags = np.concatenate([_mags(1, False, 3), _mags(2, False, 3),
                           _mags(3, False, 3), _mags(4, False, 3),
                           np.array([120.0, -100.0, 45.0], np.float32)])
    out = aug.geom_three_pass(torch.from_numpy(x), torch.from_numpy(ops),
                              torch.from_numpy(mags))
    assert np.array_equal(out.numpy(), _reference(x, ops, mags))


def test_plain_flag_is_the_flip_first():
    g, h, w = 4, 12, 20
    x = torch.from_numpy(_images(g, h, w, 3, np.uint8))
    r1, r3 = (torch.from_numpy(RNG.integers(-8, 9, (g, h)).astype(np.int32))
              for _ in range(2))
    r2 = torch.from_numpy(RNG.integers(-8, 9, (g, w)).astype(np.int32))
    big = torch.tensor([True, False, True, False])
    flipped = torch.where(big[:, None, None, None], x.flip(1, 2), x)
    assert torch.equal(geom_shift.geom_shift3(x, r1, r2, r3, big),
                       geom_shift.geom_shift3_plain(flipped, r1, r2, r3))


def test_stratified_taw_calls_k9_once_on_the_geometric_slice(monkeypatch):
    b = 28
    bounds = aug.op_bounds(b)
    calls = []

    def counted(x, r1, r2, r3, big=None):
        calls.append((x.shape[0], big is not None))
        return geom_shift.geom_shift3(x, r1, r2, r3, big)

    monkeypatch.setattr(aug, "geom_shift3", counted)
    g = torch.Generator().manual_seed(0)
    imgs = torch.randint(0, 256, (b, 16, 16, 3), generator=g, dtype=torch.uint8)
    out = aug.trivial_augment_wide_stratified(
        imgs, torch.randperm(b, generator=g),
        torch.randint(0, 31, (b,), generator=g), torch.rand(b, generator=g) < 0.5)
    assert out.shape == imgs.shape and out.dtype == torch.uint8
    assert calls == [(bounds[6] - bounds[1], True)]


@pytest.mark.parametrize("shape,variant", [
    ((224, 224, 3, 1), "smem"),     # the train step's views
    ((256, 256, 3, 1), "smem"),
    ((224, 224, 1, 4), "smem"),
    ((224, 224, 2, 4), "global"),
    ((320, 320, 3, 1), "global"),   # a 320 px view
    ((224, 224, 3, 4), "global"),   # f32 views
])
def test_variant_rule(shape, variant):
    assert geom_shift.geom_shift3_variant(*shape) == variant


def test_smem_bytes_at_224px():
    """The 16-byte mbarrier and the tables (2688 bytes), 32 warps' staged
    rows of 672 bytes, 16 bytes of alignment slack, the image."""
    assert geom_shift.smem_bytes(224, 224, 3, 1, 224) == (
        16 + 2688 + 32 * 672 + 16 + 224 * 224 * 3)
    assert geom_shift.smem_bytes(224, 224, 3, 1, 224) <= geom_shift._SMEM_LIMIT


@pytest.mark.parametrize("g,sms,split", [
    (46, 132, 2),   # the train step's geometric slice at B=128
    (128, 132, 1),
    (9, 132, 8),    # capped
    (200, 132, 1),
    (1, 132, 8),
])
def test_split_rule(g, sms, split):
    assert geom_shift.geom_shift3_split(g, sms) == split
