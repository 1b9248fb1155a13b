"""Append-only JSONL metrics stream (counterpart of
``basd_tpu/utils/logging.py``)."""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any


class MetricsLogger:
    """One JSON object per line: ``{"kind", "t", **metrics}``."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._t0 = time.time()

    def log(self, kind: str, **metrics: Any) -> None:
        rec = {"kind": kind, "t": round(time.time() - self._t0, 3), **metrics}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
