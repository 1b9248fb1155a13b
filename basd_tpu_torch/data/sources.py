"""Dataset sources and metadata probing.

Mirrors the reference's HF-datasets-based data layer
(``src/data/datasets.py``):

- ``dataset_info``: probe image/label feature keys, class count/names, and
  the preferred eval split (validation > test > train)
  (reference: ``datasets.py:24-43``);
- ``get_channel_stats``: streaming per-channel mean/std over 5,000 samples
  with Chan/Welford parallel-variance merging (reference:
  ``datasets.py:46-68``);
- ``get_subset_indices``: class-name remap of a robustness subset into the
  parent label space, e.g. ImageNet-A into ImageNet-1k (reference:
  ``datasets.py:71-77``).

TPU-first split of responsibilities: the host side ONLY decodes and
aspect-resizes to a fixed R x R uint8 canvas (R = round(img/crop_ratio));
every view (clean/augmented/eval), all augmentation, normalization, and
MixUp/CutMix run inside the jitted train step on device
(see ``basd_tpu_torch.data.augment``). One uint8 H2D copy feeds both
distillation views — the reference ships two separately-transformed f32
views per image.

A deterministic ``synthetic/*`` source family backs tests and benchmarks
in zero-egress environments.
"""

from __future__ import annotations

import hashlib
from functools import lru_cache

import numpy as np

_CHANNEL_STATS_SAMPLES = 5000

_SYNTHETIC_SPECS = {
    "synthetic/cifar100": dict(num_classes=100, native_size=32, n_train=2048, n_eval=512),
    "synthetic/cifar10": dict(num_classes=10, native_size=32, n_train=2048, n_eval=512),
    "synthetic/imagenet100": dict(num_classes=100, native_size=256, n_train=2048, n_eval=512),
    "synthetic/imagenet1k": dict(num_classes=1000, native_size=256, n_train=4096, n_eval=1024),
    "synthetic/tiny": dict(num_classes=10, native_size=40, n_train=256, n_eval=64),
    # robustness-subset fixture: classes are a named subset of
    # synthetic/tiny's label space (the ImageNet-A pattern, reference:
    # datasets.py:71-77)
    "synthetic/tiny_subset": dict(
        num_classes=4, native_size=40, n_train=64, n_eval=32,
        parent_classes=(2, 5, 7, 9),
    ),
}


def is_synthetic(name: str) -> bool:
    return name.startswith("synthetic/")


@lru_cache(maxsize=None)
def dataset_info(dataset_name: str) -> dict:
    if is_synthetic(dataset_name):
        spec = _SYNTHETIC_SPECS[dataset_name]
        c = spec["num_classes"]
        parents = spec.get("parent_classes")
        names = (
            tuple(f"class_{i:04d}" for i in parents)
            if parents
            else tuple(f"class_{i:04d}" for i in range(c))
        )
        return {
            "image_key": "img",
            "label_key": "label",
            "num_classes": c,
            "class_names": names,
            "train_split": "train",
            "eval_split": "test",
        }

    from datasets import ClassLabel, Image, load_dataset_builder

    builder = load_dataset_builder(dataset_name, trust_remote_code=True)
    features = builder.info.features
    splits = set((builder.info.splits or {}).keys())
    image_key = next(n for n, f in features.items() if isinstance(f, Image))
    label_key = next(n for n, f in features.items() if isinstance(f, ClassLabel))
    feat = features[label_key]
    eval_split = (
        "validation" if "validation" in splits else "test" if "test" in splits else "train"
    )
    return {
        "image_key": image_key,
        "label_key": label_key,
        "num_classes": feat.num_classes,
        "class_names": tuple(feat.names),
        "train_split": "train",
        "eval_split": eval_split,
    }


def welford_channel_stats(arrays) -> tuple[list, list]:
    """Chan/Welford per-channel mean/std in [0,1] over an iterator of
    (H, W, 3) uint8-like arrays (reference ``src/data/datasets.py:46-68``
    streaming semantics). Single implementation shared by the streaming
    path below and the canvas-cache build (``data/cache.py``)."""
    mean = np.zeros(3, np.float64)
    m2 = np.zeros(3, np.float64)
    count = 0
    for arr in arrays:
        flat = np.asarray(arr, np.float64).reshape(-1, 3) / 255.0
        n = flat.shape[0]
        bm = flat.mean(axis=0)
        bv = flat.var(axis=0)
        delta = bm - mean
        new_count = count + n
        mean += delta * n / new_count
        m2 += bv * n + delta**2 * count * n / new_count
        count = new_count
    if count == 0:
        raise ValueError("cannot compute channel stats from an empty iterator")
    std = np.sqrt(m2 / count)
    return mean.tolist(), std.tolist()


@lru_cache(maxsize=None)
def get_channel_stats(dataset_name: str) -> tuple[tuple[float, ...], tuple[float, ...]]:
    """Per-channel mean/std in [0,1], streaming Welford merge."""
    if is_synthetic(dataset_name):
        src = SyntheticSource(dataset_name)
        it = src.iter_examples("train", limit=min(_CHANNEL_STATS_SAMPLES, len(src)))
    else:
        from datasets import load_dataset

        info = dataset_info(dataset_name)
        ds = load_dataset(
            dataset_name, split=info["train_split"], streaming=True,
            trust_remote_code=True,
        ).take(_CHANNEL_STATS_SAMPLES)
        key = info["image_key"]
        it = (np.asarray(ex[key].convert("RGB")) for ex in ds)

    mean, std = welford_channel_stats(it)
    return tuple(mean), tuple(std)


def subset_indices_from_names(
    child: tuple, parent: tuple
) -> tuple[int, ...] | None:
    """Class-name remap of a robustness subset into the parent label space
    (reference: ``datasets.py:71-77``); None when the label spaces match."""
    if set(child) == set(parent):
        return None
    parent_map = {n: i for i, n in enumerate(parent)}
    return tuple(parent_map[n] for n in child)


def get_subset_indices(dataset_name: str, parent_name: str) -> tuple[int, ...] | None:
    return subset_indices_from_names(
        dataset_info(dataset_name)["class_names"],
        dataset_info(parent_name)["class_names"],
    )


# -- sources ---------------------------------------------------------------


class SyntheticSource:
    """Deterministic label-structured fake images.

    Each image is a class-dependent low-frequency pattern plus seeded
    noise, so models can genuinely fit the data in smoke tests.
    """

    def __init__(self, name: str):
        self.name = name
        self.spec = _SYNTHETIC_SPECS[name]
        self._seed = int.from_bytes(
            hashlib.sha256(name.encode()).digest()[:4], "little"
        )

    def __len__(self) -> int:
        return self.spec["n_train"]

    def split_size(self, split: str) -> int:
        return self.spec["n_train"] if split == "train" else self.spec["n_eval"]

    def num_classes(self) -> int:
        return self.spec["num_classes"]

    def class_names(self) -> tuple:
        return dataset_info(self.name)["class_names"]

    def _example(self, split: str, idx: int, out_size: int) -> tuple[np.ndarray, int]:
        c = self.spec["num_classes"]
        salt = 0 if split == "train" else 1_000_003
        rng = np.random.default_rng(self._seed + salt + idx)
        label = int(rng.integers(0, c))
        size = out_size
        yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / max(size - 1, 1)
        phase = 2 * np.pi * label / c
        base = np.stack(
            [
                0.5 + 0.35 * np.sin(2 * np.pi * (yy + xx) + phase),
                0.5 + 0.35 * np.cos(2 * np.pi * (yy - xx) + 2 * phase),
                0.5 + 0.35 * np.sin(4 * np.pi * yy + 3 * phase),
            ],
            axis=-1,
        )
        noise = rng.normal(0, 0.08, base.shape).astype(np.float32)
        img = np.clip(base + noise, 0, 1)
        return (img * 255).astype(np.uint8), label

    def iter_examples(self, split: str, limit: int | None = None):
        n = self.split_size(split)
        if limit is not None:
            n = min(n, limit)
        for i in range(n):
            img, _ = self._example(split, i, self.spec["native_size"])
            yield img

    def load_batches(
        self,
        split: str,
        batch_size: int,
        out_size: int,
        *,
        shuffle: bool,
        seed: int,
        drop_last: bool,
    ):
        n = self.split_size(split)
        order = np.arange(n)
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        end = (n // batch_size) * batch_size if drop_last else n
        for start in range(0, end, batch_size):
            idx = order[start : start + batch_size]
            imgs = np.empty((len(idx), out_size, out_size, 3), np.uint8)
            labels = np.empty((len(idx),), np.int32)
            for j, i in enumerate(idx):
                img, lab = self._example(split, int(i), out_size)
                imgs[j] = img
                labels[j] = lab
            yield {"image": imgs, "label": labels}


class HFSource:
    """HuggingFace-datasets source; host decodes + aspect-resizes to a
    fixed square uint8 canvas, everything else happens on device.

    Arrow access is BATCHED: each batch is one ``ds[idx_list]`` query (a
    single ``query_table`` on the arrow backend) instead of the per-item
    ``ds[i]`` pattern, which is slow on real arrow datasets. JPEG decode +
    resize fan out over ``num_workers`` threads (PIL decode and the native
    resize core both release the GIL). Reference: ``src/data/datasets.py:
    126-177`` (DataLoader with 8 persistent workers).

    ``dataset``/``info`` may be injected for offline tests (an in-memory
    ``datasets.Dataset`` exercises the same arrow path).
    """

    def __init__(
        self,
        name: str,
        *,
        num_workers: int = 8,
        dataset=None,
        info: dict | None = None,
    ):
        self.name = name
        self.num_workers = max(1, int(num_workers))
        self.info = info if info is not None else dataset_info(name)
        self._splits: dict[str, object] = {}
        if dataset is not None:
            self._splits = {
                self.info["train_split"]: dataset,
                self.info["eval_split"]: dataset,
            }

    def _split(self, split: str):
        real = self.info["train_split"] if split == "train" else self.info["eval_split"]
        if real not in self._splits:
            from datasets import load_dataset

            self._splits[real] = load_dataset(
                self.name, split=real, trust_remote_code=True
            )
        return self._splits[real]

    def split_size(self, split: str) -> int:
        return len(self._split(split))

    def num_classes(self) -> int:
        return self.info["num_classes"]

    def class_names(self) -> tuple:
        return tuple(self.info["class_names"])

    def _decode(self, img, out_size: int) -> np.ndarray:
        # aspect-preserving shorter-side resize then center crop, i.e.
        # torchvision Resize(out) + CenterCrop(out) semantics. The resize
        # runs in the native C++ core (basd_tpu_torch/data/native) so a thin
        # host CPU can keep the TPU fed; PIL only decodes.
        from basd_tpu_torch.data.native import resize_center_crop

        return resize_center_crop(
            np.asarray(img.convert("RGB"), np.uint8), out_size
        )

    def load_batches(
        self,
        split: str,
        batch_size: int,
        out_size: int,
        *,
        shuffle: bool,
        seed: int,
        drop_last: bool,
    ):
        import concurrent.futures as cf

        ds = self._split(split)
        n = len(ds)
        order = np.arange(n)
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        end = (n // batch_size) * batch_size if drop_last else n
        image_key = self.info["image_key"]
        label_key = self.info["label_key"]

        with cf.ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            for start in range(0, end, batch_size):
                idx = [int(i) for i in order[start : start + batch_size]]
                batch = ds[idx]  # ONE batched arrow query
                imgs = list(
                    pool.map(
                        lambda im: self._decode(im, out_size),
                        batch[image_key],
                    )
                )
                yield {
                    "image": np.stack(imgs),
                    "label": np.asarray(batch[label_key], np.int32),
                }


def make_source(
    name: str,
    source_kind: str = "hf",
    *,
    num_workers: int = 8,
    cache_dir: str | None = None,
):
    # explicit source=cached wins over the synthetic-name shortcut so a
    # cache built FROM a synthetic source (tests; fully network-free eval)
    # streams through the real CachedSource path
    if source_kind == "cached":
        from basd_tpu_torch.data.cache import CachedSource

        if cache_dir is None:
            raise ValueError("data.source=cached requires data.cache_dir")
        return CachedSource(name, cache_dir)
    if is_synthetic(name) or source_kind == "synthetic":
        return SyntheticSource(name)
    return HFSource(name, num_workers=num_workers)


def source_from_config(config, name: str | None = None):
    """Build the configured source (``data.source``: hf | cached |
    synthetic) for ``name`` (default: the primary dataset)."""
    return make_source(
        name if name is not None else config.data.dataset,
        config.data.get("source", "hf"),
        num_workers=config.data.get("num_workers", 8),
        cache_dir=config.data.get("cache_dir"),
    )


def stats_from_config(config) -> tuple[tuple, tuple]:
    """Primary-dataset channel stats. In cached mode they come from the
    cache's meta.json (recorded at build time), so training needs no
    network access at all."""
    name = config.data.dataset
    if config.data.get("source", "hf") == "cached":
        from basd_tpu_torch.data.cache import CachedSource

        cache_dir = config.data.get("cache_dir")
        if cache_dir is None:
            raise ValueError("data.source=cached requires data.cache_dir")
        return CachedSource(name, cache_dir).channel_stats()
    return get_channel_stats(name)
