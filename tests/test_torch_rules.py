"""Rules of the port: it never loads JAX, a CUDA tensor never takes a plain
version, and nothing falls back to the CPU quietly."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from lsd_slam_tpu_torch.camera import Camera
from lsd_slam_tpu_torch.config import LSDConfig, SystemConfig
from lsd_slam_tpu_torch.ops import regularize_stencil as stencil
from lsd_slam_tpu_torch.system import SlamSystem

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAM = Camera(fx=112.0, fy=112.0, cx=79.5, cy=63.5, width=160, height=128)
CFG = LSDConfig(width=160, height=128)

# modules present before the port is imported (an interpreter start-up hook
# may load some) are not the port's doing, so only new ones count
_IMPORT_ALL = r"""
import importlib, pkgutil, sys
before = set(sys.modules)
import lsd_slam_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
bad = sorted(n for n in set(sys.modules) - before
             if n.split(".")[0] in ("jax", "jaxlib", "flax", "lsd_slam_tpu"))
print("BAD", bad)
"""


def test_importing_the_port_loads_no_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


@pytest.mark.cuda
def test_cuda_tensor_never_takes_the_plain_version(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")

    def plain(*a, **k):
        raise AssertionError("plain version reached with CUDA tensors")

    monkeypatch.setattr(stencil, "regularize_accumulators_plain", plain)
    planes = [torch.rand(37, 53, device="cuda") for _ in range(4)]
    before = stencil.LAUNCHES
    out = stencil.regularize_accumulators(*planes, 0.005625, 1.0)
    torch.cuda.synchronize()
    assert stencil.LAUNCHES == before + 1
    assert all(o.is_cuda and o.shape == (37, 53) for o in out)


def test_wrapper_takes_no_plain_version_off_the_cpu():
    """Only CPU tensors take the plain version: tensors on any other device
    than the CPU or a CUDA card raise instead of computing anything."""
    meta = [torch.empty(8, 8, device="meta") for _ in range(4)]
    with pytest.raises(ValueError):
        stencil.regularize_accumulators(*meta, 0.005625, 1.0)


def test_slam_system_without_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        SlamSystem(CAM, CFG)


def test_slam_system_runs_where_asked():
    sys_ = SlamSystem(CAM, CFG, device="cpu")
    assert sys_.device.type == "cpu"
    assert sys_.map.device.type == "cpu"


@pytest.mark.parametrize("kw", [
    dict(enable_slam=True),
    dict(cfg=CFG.replace(system=SystemConfig(pipeline_lag=2))),
    dict(cfg=CFG.replace(system=SystemConfig(sequential=False))),
])
def test_unported_modes_raise(kw):
    args = dict(cfg=CFG, device="cpu")
    args.update(kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        SlamSystem(CAM, **args)


def test_unported_mapping_paths_raise():
    sys_ = SlamSystem(CAM, CFG, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        sys_.update_keyframe_batch([object()])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        sys_.load_existing_keyframe(None)
    img = np.zeros((128, 160), np.float32)
    assert sys_._attempt_relocalization(img, 0, 0.0) is None
