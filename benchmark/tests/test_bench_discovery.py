"""A new configuration, traffic mix, camera model and per-layer metric
need only new files and new entries: in a temporary copy of the
benchmark, a throwaway of each is added (no file of the copy edited but
BENCHMARK.json, which gains entries) and a traced run of the new cell on
the CPU finds them all by name and reports the new metric."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def test_new_cell_mix_camera_and_metric_are_found_by_name(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())

    b = tmp_path / "benchmark"
    cam = json.loads((b / "configs" / "tum_fr3_vga.json").read_text())
    cam["camera"] = {"model": "throwaway_pinhole", "width": 160,
                     "height": 128, "fx": 134.0, "fy": 135.0, "cx": 80.1,
                     "cy": 62.3}
    (b / "configs" / "throwaway.json").write_text(json.dumps(cam))
    (b / "cameras" / "throwaway_pinhole.py").write_text(
        "from benchmark.cameras.pinhole import Setup  # noqa: F401\n")
    mix = json.loads((b / "traffic" / "loop.json").read_text())
    mix.update(lap_frames=520, frames=520, check_every=4)
    (b / "traffic" / "throwaway_mix.json").write_text(json.dumps(mix))
    (b / "metrics" / "throwaway_metric.py").write_text(
        "def read(run):\n    return 42.0 if run.window_frames() else None\n")
    limits = json.loads((b / "limits" / "tum_fr3_vga.loop.json").read_text())
    (b / "limits" / "throwaway.throwaway_mix.json").write_text(
        json.dumps(limits))
    bench["configs"].append({"name": "throwaway", "source": "none",
                             "file": "benchmark/configs/throwaway.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "throwaway.throwaway_mix",
                               "config": "throwaway",
                               "traffic": "throwaway_mix", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "throwaway_metric", "unit": "x",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "engine loop",
                               "moves": "frames_per_s",
                               "workloads": ["throwaway.throwaway_mix"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "throwaway.throwaway_mix", "--seed", "5", "--seconds", "4",
         "--trace", "1", "--device", "cpu"],
        cwd=tmp_path, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    # only the metric whose `workloads` list the new cell is reported
    assert set(line["metrics"]) == {"throwaway_metric"}
    assert line["metrics"]["throwaway_metric"]["value"] == 42.0
    assert list(line)[-1] == "checks"
    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in (tmp_path / "benchmark").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items()), \
        "a file of the benchmark was edited"


def test_a_checkout_without_the_program_fails(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's
    files the run exits with an error and prints no result."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "tum_fr3_vga.loop", "--seed", "1", "--seconds", "1", "--trace",
         "0", "--device", "cpu"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
