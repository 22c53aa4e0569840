"""The run's last check: a loaded module whose top-level name, compared
whole, is JAX's or the JAX package's fails the run; the port passes."""

import os
import subprocess
import sys
from pathlib import Path

from benchmark import run

ROOT = Path(__file__).resolve().parents[2]


def test_forbidden_names_are_caught_whole():
    assert run.forbidden_modules({"lsd_slam_tpu": 1}) == ["lsd_slam_tpu"]
    assert run.forbidden_modules({"lsd_slam_tpu.utils.synth": 1}) == [
        "lsd_slam_tpu"]
    assert run.forbidden_modules({"jax.numpy": 1, "jaxlib": 1}) == [
        "jax", "jaxlib"]
    assert run.forbidden_modules({"flax.linen": 1}) == ["flax"]


def test_the_port_and_lookalikes_pass():
    assert run.forbidden_modules({"lsd_slam_tpu_torch": 1,
                                  "lsd_slam_tpu_torch.system": 1,
                                  "jaxtyping": 1, "flaxen": 1,
                                  "benchmark.run": 1}) == []


def test_the_harness_and_the_port_load_none_of_them():
    """A fresh process that imports every harness module and the port's
    engine holds no forbidden module."""
    code = ("import benchmark.run as r, benchmark.harness.reference, "
            "benchmark.harness.stream, benchmark.harness.window, "
            "benchmark.harness.trace, benchmark.cameras.radtan, "
            "lsd_slam_tpu_torch.system, lsd_slam_tpu_torch.camera.undistort;"
            "print(r.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
