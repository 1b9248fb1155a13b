"""Checkpoints with ``torch.save`` (counterpart of
``basd_tpu/utils/checkpoint.py``): full train-state directories
(``best_model``, ``latest``) with a JSON sidecar ``custom_state.json``
{epoch, best_val_acc, metrics_history}, and plain weights files
(``best_model_weights``, ``final_model_weights``) with ``.meta.json``."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any

import torch


def save_state(path: str | Path, state: Any, custom: dict) -> None:
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    torch.save(state, path / "state.pt")
    with open(path / "custom_state.json", "w") as f:
        json.dump(custom, f)


def load_state(path: str | Path, map_location=None) -> tuple[Any, dict]:
    path = Path(path)
    state = torch.load(path / "state.pt", map_location=map_location,
                       weights_only=True)
    with open(path / "custom_state.json") as f:
        custom = json.load(f)
    return state, custom


def save_weights(path: str | Path, params: dict, epoch: int) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in params.items()},
               str(path) + ".pt")
    with open(str(path) + ".meta.json", "w") as f:
        json.dump({"epoch": epoch}, f)


def load_weights(path: str | Path, map_location=None) -> tuple[dict, int]:
    params = torch.load(str(path) + ".pt", map_location=map_location,
                        weights_only=True)
    meta = Path(str(path) + ".meta.json")
    epoch = json.loads(meta.read_text()).get("epoch", -1) if meta.exists() else -1
    return params, epoch
