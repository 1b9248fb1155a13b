"""Decoded-canvas cache: preprocess once, stream at memory bandwidth.

The reference feeds training from 8 persistent DataLoader workers that
decode + transform JPEGs every epoch (``src/data/datasets.py:126-177``) —
viable on a many-core GPU host. This build's host work is decode +
aspect-resize only, but on a 1-core TPU host that is ~90 img/s (measured,
``scripts/bench_host_feed.py``) against a train step that consumes ~1,900
img/s: a raw HF-ImageNet run would be ~20x host-bound.

The TPU-first answer: every training view is generated ON DEVICE from one
fixed R x R uint8 canvas per image (R = round(img/crop_ratio); see
``basd_tpu_torch.data.augment``), so the canvas is the ONLY thing the host ever
produces — and it is deterministic per image. ``build_canvas_cache``
decodes the dataset once into a memmapped uint8 .npy per split (plus
labels and a meta.json with Welford channel stats), and ``CachedSource``
streams it back with zero per-epoch decode work. Cached reads measure
~10,000+ img/s on the same 1-core host (page-cache gather; see
BASELINE.md "host feed" table), comfortably above chip consumption.

CLI (console script ``basd-cache``):

    python -m basd_tpu_torch.data.cache --dataset uoft-cs/cifar100 \
        --cache-dir /data/basd_cache --out-size 256

Layout: ``<cache_dir>/<dataset with '/'->'_'>/{meta.json,
<split>_<R>_images.npy, <split>_<R>_labels.npy}`` for the train and eval
splits.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np

_CHANNEL_STATS_SAMPLES = 5000  # reference: src/data/datasets.py:54


def cache_root(cache_dir: str | Path, dataset_name: str) -> Path:
    return Path(cache_dir) / dataset_name.replace("/", "_")


def _img_path(root: Path, split: str, out_size: int) -> Path:
    return root / f"{split}_{out_size}_images.npy"


def _lab_path(root: Path, split: str, out_size: int) -> Path:
    return root / f"{split}_{out_size}_labels.npy"


def _canvas_channel_stats(imgs: np.ndarray, limit: int) -> tuple[list, list]:
    """Per-channel mean/std over the first ``limit`` canvases via the
    shared Welford merge (``sources.welford_channel_stats``; reference
    semantics stream RAW images, ``src/data/datasets.py:46-68`` — the
    shorter-side resize + center crop shifts the statistics by well under
    the augmentation noise floor)."""
    from basd_tpu_torch.data.sources import welford_channel_stats

    return welford_channel_stats(
        imgs[i] for i in range(min(limit, imgs.shape[0]))
    )


def build_canvas_cache(
    source,
    dataset_name: str,
    cache_dir: str | Path,
    out_size: int,
    *,
    splits: tuple[str, ...] = ("train", "eval"),
    batch_size: int = 256,
    channel_stats: tuple | None = None,
    verbose: bool = True,
) -> Path:
    """Decode ``source`` once into memmapped canvases under ``cache_dir``.

    ``source`` is any object with the ``load_batches``/``split_size``/
    ``num_classes`` source protocol (``HFSource`` reuses its batched-arrow
    + native-resize decode path; ``SyntheticSource`` works for tests).
    ``channel_stats``: optionally record externally computed (e.g.
    raw-image reference-semantics) stats instead of canvas-derived ones.
    Returns the cache root directory.
    """
    root = cache_root(cache_dir, dataset_name)
    root.mkdir(parents=True, exist_ok=True)

    meta: dict = {
        "dataset": dataset_name,
        "out_size": out_size,
        "num_classes": int(source.num_classes()),
        "splits": {},
    }
    names = getattr(source, "class_names", None)
    if callable(names):
        meta["class_names"] = list(names())

    for split in splits:
        n = source.split_size(split)
        t0 = time.perf_counter()
        imgs = np.lib.format.open_memmap(
            _img_path(root, split, out_size),
            mode="w+",
            dtype=np.uint8,
            shape=(n, out_size, out_size, 3),
        )
        labs = np.lib.format.open_memmap(
            _lab_path(root, split, out_size),
            mode="w+",
            dtype=np.int32,
            shape=(n,),
        )
        i = 0
        for batch in source.load_batches(
            split, batch_size, out_size, shuffle=False, seed=0, drop_last=False
        ):
            b = batch["image"].shape[0]
            imgs[i : i + b] = batch["image"]
            labs[i : i + b] = batch["label"]
            i += b
            if verbose and (i // batch_size) % 20 == 0:
                rate = i / max(time.perf_counter() - t0, 1e-9)
                print(
                    f"cache {dataset_name} {split}: {i}/{n} "
                    f"({rate:.1f} img/s decode)",
                    flush=True,
                )
        assert i == n, f"source yielded {i} != split_size {n}"
        # Record stats from the train split when present, else from the
        # first non-empty split (eval-only robustness caches have no
        # 'train'; without this the cache would have no channel_mean and
        # CachedSource.channel_stats() would fail later).
        want_stats = split == "train" or (
            "train" not in splits and "channel_mean" not in meta and n > 0
        )
        if want_stats:
            if channel_stats is not None:
                mean, std = channel_stats
                meta["channel_stats_source"] = "provided"
            else:
                mean, std = _canvas_channel_stats(imgs, _CHANNEL_STATS_SAMPLES)
                meta["channel_stats_source"] = f"canvas:{split}"
            meta["channel_mean"] = list(map(float, mean))
            meta["channel_std"] = list(map(float, std))
        imgs.flush()
        labs.flush()
        del imgs, labs
        meta["splits"][split] = {"n": n}
        if verbose:
            dt = time.perf_counter() - t0
            print(
                f"cache {dataset_name} {split}: {n} canvases in {dt:.1f}s "
                f"({n / max(dt, 1e-9):.1f} img/s)",
                flush=True,
            )

    with open(root / "meta.json", "w") as f:
        json.dump(meta, f, indent=2)
    return root


class CachedSource:
    """Streams preprocessed uint8 canvases from a ``build_canvas_cache``
    directory — the exact tensors the jitted train step ingests, read via
    memmap gather (no decode, no resize, no per-epoch host compute).
    """

    def __init__(self, name: str, cache_dir: str | Path):
        self.name = name
        self.root = cache_root(cache_dir, name)
        meta_path = self.root / "meta.json"
        if not meta_path.exists():
            raise FileNotFoundError(
                f"no canvas cache for '{name}' under {self.root} — build it "
                f"once with: python -m basd_tpu_torch.data.cache --dataset {name} "
                f"--cache-dir {cache_dir} --out-size <R>"
            )
        self.meta = json.loads(meta_path.read_text())
        self._mm: dict = {}

    # ---------------------------------------------------- source protocol

    def split_size(self, split: str) -> int:
        return int(self.meta["splits"][split]["n"])

    def __len__(self) -> int:
        return self.split_size("train")

    def num_classes(self) -> int:
        return int(self.meta["num_classes"])

    def channel_stats(self) -> tuple[tuple, tuple]:
        if "channel_mean" not in self.meta:
            raise KeyError(
                f"cache for '{self.name}' has no channel stats (built from "
                f"splits {list(self.meta['splits'])} before stats covered "
                f"non-train builds) — rebuild it, or pass explicit "
                f"channel_stats to build_canvas_cache"
            )
        return (
            tuple(self.meta["channel_mean"]),
            tuple(self.meta["channel_std"]),
        )

    def class_names(self) -> tuple:
        if "class_names" not in self.meta:
            raise KeyError(
                f"cache for '{self.name}' has no class names (built from a "
                f"source that does not expose class_names()) — rebuild it "
                f"with basd-cache, or from a source with class names"
            )
        return tuple(self.meta["class_names"])

    def _arrays(self, split: str, out_size: int):
        key = (split, out_size)
        if key not in self._mm:
            ipath = _img_path(self.root, split, out_size)
            if not ipath.exists():
                cached = self.meta["out_size"]
                raise FileNotFoundError(
                    f"cache for '{self.name}' was built at out_size="
                    f"{cached}, not {out_size} ({ipath} missing) — rebuild "
                    f"with --out-size {out_size}"
                )
            self._mm[key] = (
                np.load(ipath, mmap_mode="r"),
                np.load(_lab_path(self.root, split, out_size)),
            )
        return self._mm[key]

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
        imgs, labs = self._arrays(split, out_size)
        n = imgs.shape[0]
        order = np.arange(n)
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        end = (n // batch_size) * batch_size if drop_last else n
        for start in range(0, end, batch_size):
            idx = order[start : start + batch_size]
            yield {
                "image": np.asarray(imgs[idx]),
                "label": np.asarray(labs[idx], np.int32),
            }


def main(argv: list[str] | None = None) -> None:
    import argparse

    from basd_tpu_torch.data.sources import get_channel_stats, make_source

    p = argparse.ArgumentParser(
        description="Build the decoded-canvas cache for a dataset."
    )
    p.add_argument("--dataset", required=True, help="HF or synthetic/* name")
    p.add_argument("--cache-dir", required=True)
    p.add_argument(
        "--out-size",
        type=int,
        required=True,
        help="canvas side R = round(img_size / eval_crop_ratio), e.g. 256",
    )
    p.add_argument("--splits", nargs="+", default=["train", "eval"])
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--num-workers", type=int, default=8)
    p.add_argument(
        "--reference-stats",
        action="store_true",
        help="record raw-image streaming channel stats (needs network for "
        "HF datasets) instead of canvas-derived ones",
    )
    args = p.parse_args(argv)

    source = make_source(args.dataset, num_workers=args.num_workers)
    stats = get_channel_stats(args.dataset) if args.reference_stats else None
    root = build_canvas_cache(
        source,
        args.dataset,
        args.cache_dir,
        args.out_size,
        splits=tuple(args.splits),
        batch_size=args.batch_size,
        channel_stats=stats,
    )
    print(f"cache built at {root}")


if __name__ == "__main__":
    main()
