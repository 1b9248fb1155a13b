"""The harness's files and contract, its refusal without a card, and one
cell on the card."""

import importlib
import json
import os
import re
import subprocess
import sys

import pytest

from portbench import check
from portbench.cells import BENCH_DIR, ROOT, load_cell

BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCHMARK["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    cell = load_cell(name)
    assert cell.traffic["pool"] > 3 and cell.traffic["batch"] > 0
    assert set(check.NUMBERS) <= set(cell.limits)
    assert cell.config["name"] == cell.config_name
    for m in cell.per_layer:
        reader = importlib.import_module(f"portbench.metrics.{m['name']}")
        assert callable(reader.read)
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s",
                                                    "train_img_per_s"}


def test_contract_shape():
    b = BENCHMARK
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    names += [c["name"] for c in b["configs"]] + CELLS
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("portbench/")
        assert 1 <= len(c["why"]) <= 200 and not c["reduced"]
    for w in b["workloads"]:
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert UNIT.match(m["unit"]) and 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert (BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()
    assert len(json.dumps(b)) < 64 * 1024


def test_run_without_a_card_fails_and_prints_nothing():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, str(BENCH_DIR / "run.py"), "--workload", CELLS[0],
         "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr


@pytest.mark.card
def test_one_cell_on_the_card(card):
    p = subprocess.run(
        [sys.executable, str(BENCH_DIR / "run.py"), "--workload", CELLS[0],
         "--seed", str(2 ** 31 + 7), "--seconds", "3", "--trace", "1"],
        capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["busy_s"] > 0
    assert list(result)[-1] == "checks"
