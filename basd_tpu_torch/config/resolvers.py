"""Custom config resolvers matching the reference's OmegaConf resolvers.

Reference: ``src/resolvers.py:6-21`` registers three resolvers that make the
config dataset-reactive:

- ``num_classes``: probe the dataset for its class count;
- ``label_smoothing``: ``1 / num_classes``;
- ``eval_crop_ratio``: ``img / (img + 2 * patch)`` (DeiT eval convention).
"""

from __future__ import annotations

from basd_tpu_torch.config.core import register_resolver


def _num_classes(dataset_name: str) -> int:
    from basd_tpu_torch.data.sources import dataset_info

    return dataset_info(dataset_name)["num_classes"]


def _label_smoothing(dataset_name: str) -> float:
    from basd_tpu_torch.data.sources import dataset_info

    return 1.0 / dataset_info(dataset_name)["num_classes"]


def _eval_crop_ratio(img_size: int, patch_size: int) -> float:
    return img_size / (img_size + 2 * patch_size)


def register_resolvers() -> None:
    register_resolver("num_classes", _num_classes)
    register_resolver("label_smoothing", _label_smoothing)
    register_resolver("eval_crop_ratio", _eval_crop_ratio)
