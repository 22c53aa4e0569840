"""Find a cell's pieces by name: the cell in BENCHMARK.json, its
configuration (`configs/<name>.json`), its traffic mix
(`traffic/<name>.json`), its camera model (`cameras/<model>.py`) and the
readers of its per-layer metrics (`metrics/<name>.py`). A new cell, mix,
camera or metric is a new file and a new entry; nothing here changes."""

from __future__ import annotations

import importlib
import json
from dataclasses import dataclass, field
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _for_cell(metrics, cell_name):
    """The metrics a cell reports: those without `workloads`, and those
    whose `workloads` list the cell."""
    return [m for m in metrics
            if "workloads" not in m or cell_name in m["workloads"]]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[w["config"]]
    bench_dir = root / "benchmark"
    with open(root / cfg_entry["file"]) as f:
        config = json.load(f)
    with open(bench_dir / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic,
                end_to_end=_for_cell(bench["end_to_end"], name),
                per_layer=_for_cell(bench["per_layer"], name))


def camera_model(name: str):
    """The module of camera model `name` (`cameras/<name>.py`)."""
    return importlib.import_module(f"benchmark.cameras.{name}")


def metric_reader(name: str):
    """The `read(run)` of per-layer metric `name` (`metrics/<name>.py`)."""
    return importlib.import_module(f"benchmark.metrics.{name}").read
