"""The port's own config and data-feed modules (``basd_tpu_torch.config``,
``basd_tpu_torch.data.sources`` / ``pipeline`` / ``cache`` /
``native``) against the JAX package's, which they copy: the same composed
configs, the same synthetic batches, the same channel statistics and the
same canvas cache, on the same inputs."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest

from basd_tpu import config as jconfig
from basd_tpu.data import cache as jcache
from basd_tpu.data import pipeline as jpipeline
from basd_tpu.data import sources as jsources
from basd_tpu_torch import config as tconfig
from basd_tpu_torch.data import cache as tcache
from basd_tpu_torch.data import native as tnative
from basd_tpu_torch.data import pipeline as tpipeline
from basd_tpu_torch.data import sources as tsources

CONFIG_DIR = Path(__file__).resolve().parent.parent / "configs"


@pytest.mark.parametrize("overrides", [
    ["experiment=smoke_synthetic"],
    ["experiment=basd_imagenet_deit_small", "data.dataset=synthetic/imagenet100",
     "tpu.student_attention_impl=module", "+data.limit_train_batches=3"],
    ["experiment=basd_cifar100", "data.dataset=synthetic/cifar100",
     "training.num_epochs=2", "model.vit.patch_size=8"],
])
def test_composed_config_matches_jax_package(overrides, tmp_path):
    jconfig.register_resolvers()
    tconfig.register_resolvers()
    ref = jconfig.compose(CONFIG_DIR, overrides=overrides)
    ours = tconfig.compose(CONFIG_DIR, overrides=overrides)
    assert ours.to_dict() == ref.to_dict()
    jconfig.save_config(ref, tmp_path / "ref.yaml")
    tconfig.save_config(ours, tmp_path / "ours.yaml")
    assert (tmp_path / "ours.yaml").read_text() == (tmp_path / "ref.yaml").read_text()
    assert tconfig.load_config(tmp_path / "ours.yaml").to_dict() == ref.to_dict()


@pytest.mark.parametrize("name,size", [("synthetic/imagenet100", 64),
                                       ("synthetic/tiny", 40)])
def test_synthetic_batches_and_stats_match_jax_package(name, size):
    jconfig.register_resolvers()
    tconfig.register_resolvers()
    overrides = ["experiment=smoke_synthetic", f"data.dataset={name}",
                 "data.source=synthetic"]
    jcfg = jconfig.compose(CONFIG_DIR, overrides=overrides)
    tcfg = tconfig.compose(CONFIG_DIR, overrides=overrides)
    assert tsources.stats_from_config(tcfg) == jsources.stats_from_config(jcfg)
    assert tsources.dataset_info(name) == jsources.dataset_info(name)
    want = jsources.source_from_config(jcfg).load_batches(
        "train", 8, size, shuffle=True, seed=3, drop_last=True)
    got = tpipeline.prefetch(tsources.source_from_config(tcfg).load_batches(
        "train", 8, size, shuffle=True, seed=3, drop_last=True))
    for _, w, g in zip(range(3), want, got):
        np.testing.assert_array_equal(g["image"], w["image"])
        np.testing.assert_array_equal(g["label"], w["label"])


def test_welford_stats_and_prefetch_match_jax_package():
    rng = np.random.default_rng(4)
    arrays = [rng.integers(0, 256, (int(rng.integers(8, 20)), 12, 3),
                           dtype=np.uint8) for _ in range(7)]
    assert (tsources.welford_channel_stats(iter(arrays))
            == jsources.welford_channel_stats(iter(arrays)))
    items = list(range(11))
    assert list(tpipeline.prefetch(iter(items), depth=3)) == list(
        jpipeline.prefetch(iter(items), depth=3))

    def failing():
        yield 1
        raise KeyError("boom")

    with pytest.raises(KeyError):
        list(tpipeline.prefetch(failing()))


def test_canvas_cache_matches_jax_package(tmp_path):
    name = "synthetic/tiny"
    src = tsources.SyntheticSource(name)
    ours = tcache.build_canvas_cache(src, name, tmp_path / "ours", 40,
                                     batch_size=50, verbose=False)
    ref = jcache.build_canvas_cache(jsources.SyntheticSource(name), name,
                                    tmp_path / "ref", 40, batch_size=50,
                                    verbose=False)
    files = sorted(p.name for p in ref.iterdir())
    assert sorted(p.name for p in ours.iterdir()) == files
    for f in files:
        if f.endswith(".npy"):
            np.testing.assert_array_equal(np.load(ours / f), np.load(ref / f))
    cached = tcache.CachedSource(name, tmp_path / "ours")
    assert cached.channel_stats() == jcache.CachedSource(
        name, tmp_path / "ref").channel_stats()
    for w, g in zip(src.load_batches("eval", 16, 40, shuffle=False, seed=0,
                                     drop_last=False),
                    cached.load_batches("eval", 16, 40, shuffle=False, seed=0,
                                        drop_last=False)):
        np.testing.assert_array_equal(g["image"], w["image"])


def test_native_resize_matches_pil_fallback():
    """The port's resize core (native C++ where a compiler is present)
    against its own PIL fallback, the semantics both packages share."""
    rng = np.random.default_rng(8)
    img = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    got = tnative.resize_center_crop(img, 24)
    ref = tnative._numpy_resize_center_crop(img, 24)
    assert got.shape == ref.shape == (24, 24, 3)
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
