"""Finding a cell by name: its entry in ``BENCHMARK.json``, its
configuration file, its traffic file and its limits file, and the metric
entries that apply to it. Adding a cell, a configuration, a traffic mix or
a per-layer metric adds files and entries; nothing here changes."""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


@dataclass(frozen=True)
class Cell:
    name: str
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: dict
    chips: int
    end_to_end: list
    per_layer: list


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = _load(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; cells: "
                       f"{[w['name'] for w in bench['workloads']]}")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return Cell(
        name=name, config_name=conf["name"], config=_load(root / conf["file"]),
        traffic_name=entry["traffic"],
        traffic=_load(BENCH_DIR / "traffic" / f"{entry['traffic']}.json"),
        limits=_load(BENCH_DIR / "limits" / f"{name}.json"),
        chips=int(entry["chips"]),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )
