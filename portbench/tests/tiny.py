"""A tiny cell for the CPU tests: both configurations' shape at widths a
test run holds, in float32 so that the port's plain CPU path and the
reference agree to rounding."""

from __future__ import annotations

import copy
import json

from portbench import check
from portbench.cells import BENCH_DIR, Cell


def tiny_cell(config: str = "dinov2_b14-s320_gram", batch: int = 8,
              compute: str = "float32", limits=None, teacher=None) -> Cell:
    """``teacher``: entries laid over the tiny teacher's (its MLP kind)."""
    with open(BENCH_DIR / "configs" / f"{config}.json") as f:
        c = json.load(f)
    c = copy.deepcopy(c)
    c["img_size"] = 32
    c["num_classes"] = 10
    c["label_smoothing"] = 0.1
    c["precision"]["compute"] = compute
    p_t = 8 if c["teacher"]["patch_size"] == 14 else 16
    c["teacher"].update(preset="tiny_teacher", custom=True, embed_dim=64,
                        depth=3, num_heads=2, patch_size=p_t)
    c["teacher"].update(teacher or {})
    c["student"].update(preset="tiny_student", custom=True, embed_dim=32,
                        depth=3, num_heads=2, patch_size=16)
    if c["basd"].get("max_rank"):
        c["basd"]["max_rank"] = 16
    traffic = {"batch": batch, "pool": 4, "canvas": 36, "noise_std": 0.08,
               "amplitude": 0.35}
    lim = limits or dict.fromkeys(check.NUMBERS, 1.0)
    return Cell(name=f"tiny.{config}", config_name=config, config=c,
                traffic_name="tiny", traffic=traffic, limits=lim, chips=1,
                end_to_end=[{"name": "train_img_per_s", "unit": "img/s"},
                            {"name": "peak_mem_gib", "unit": "GiB"},
                            {"name": "setup_s", "unit": "s"}],
                per_layer=[])
