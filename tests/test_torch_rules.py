"""Rules of the port: it never loads JAX, a CUDA tensor never takes a plain
version, and nothing falls back to the CPU quietly."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from lsd_slam_tpu_torch import interop
from lsd_slam_tpu_torch.camera import Camera
from lsd_slam_tpu_torch.config import LSDConfig, SystemConfig
from lsd_slam_tpu_torch.depth.state import DepthMapState
from lsd_slam_tpu_torch.mapping.pose_graph import PoseGraph
from lsd_slam_tpu_torch.ops import regularize_stencil as stencil
from lsd_slam_tpu_torch.system import SlamSystem
from lsd_slam_tpu_torch.utils import synth

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


@pytest.mark.cuda
def test_fused_cuda_tensors_never_take_the_plain_version(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")

    def plain(*a, **k):
        raise AssertionError("plain version reached with CUDA tensors")

    monkeypatch.setattr(stencil, "regularize_plain", plain)
    monkeypatch.setattr(stencil, "regularize_accumulators_plain", plain)
    f32 = [torch.rand(37, 53, device="cuda") for _ in range(5)]
    valid = torch.rand(37, 53, device="cuda") < 0.6
    bl = torch.zeros(37, 53, dtype=torch.int32, device="cuda")
    before = stencil.FUSED_LAUNCHES
    out = stencil.regularize_fused(f32[0], f32[1], valid, f32[2], f32[3],
                                   f32[4], bl, 0.005625, 1.0, 24.0, True)
    torch.cuda.synchronize()
    assert stencil.FUSED_LAUNCHES == before + 1
    assert [o.dtype for o in out] == [torch.bool, torch.int32,
                                      torch.float32, torch.float32]
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


@pytest.mark.parametrize("entry", ["depth_state", "frame_pyramid",
                                   "depth_pyramid", "point_set",
                                   "tracking_ref", "render", "render_bench",
                                   "render_realistic", "pose_graph",
                                   "pose_graph_from_dict", "reactivation"])
def test_entry_points_without_device_raise_without_cuda(monkeypatch, entry):
    """The state carried across and the synthetic renderer run on the card
    unless the caller names a device; without one they raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    z = np.zeros((4, 4), np.float32)
    ident = np.array([1, 0, 0, 0, 0, 0, 0], np.float32)
    calls = {
        "depth_state": lambda: interop.depth_state_from_dict(
            {f.name: z for f in dataclasses.fields(DepthMapState)}),
        "frame_pyramid": lambda: interop.frame_pyramid_from_dict(
            dict(images=[z], gx=[z], gy=[z], max_grad=[z], quad=[z],
                 num_mappable=0.0)),
        "depth_pyramid": lambda: interop.depth_pyramid_from_dict(
            dict(idepth=[z], ivar=[z])),
        "point_set": lambda: interop.point_set_from_dict(
            dict(idx=[0], ival=z, gx=z, gy=z, idp=z, ivr=z, valid=z,
                 n_valid=1.0)),
        "tracking_ref": lambda: interop.tracking_ref_from_dict(
            dict(pts=[dict(idx=[0], ival=z, gx=z, gy=z, idp=z, ivr=z,
                           valid=z, n_valid=1.0)])),
        "render": lambda: synth.render(synth.PlaneScene(seed=0), CAM,
                                       np.array([1, 0, 0, 0, 0, 0, 0],
                                                np.float32)),
        "render_bench": lambda: synth.render_bench(
            synth.BenchScene(seed=0), CAM, ident),
        "render_realistic": lambda: synth.render_realistic(
            synth.BenchScene(seed=0), CAM, ident, noise_sigma=0.0),
        "pose_graph": lambda: PoseGraph(),
        "pose_graph_from_dict": lambda: interop.pose_graph_from_dict(
            dict(poses=[], fixed=[], e_from=[], e_to=[], e_meas_inv=[],
                 e_info=[], e_delta=[])),
        "reactivation": lambda: interop.reactivation_from_dict(
            dict(idepth=z, var=z, validity=z)),
    }
    with pytest.raises(RuntimeError, match='device="cpu"'):
        calls[entry]()


def test_slam_system_runs_where_asked():
    sys_ = SlamSystem(CAM, CFG, device="cpu")
    assert sys_.device.type == "cpu"
    assert sys_.map.device.type == "cpu"


@pytest.mark.parametrize("kw", [
    dict(cfg=CFG.replace(system=SystemConfig(use_fabmap=True))),
    dict(cfg=CFG.replace(system=SystemConfig(pipeline_lag=2))),
    dict(cfg=CFG.replace(system=SystemConfig(sequential=False))),
])
def test_unported_modes_raise(kw):
    args = dict(cfg=CFG, device="cpu")
    args.update(kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        SlamSystem(CAM, **args)


def test_unported_mapping_paths_raise():
    """The unfused queue-drain observe and the sequential=False back-end
    raise; VO mode has no relocaliser (it returns at once, as in JAX)."""
    sys_ = SlamSystem(CAM, CFG, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        sys_.update_keyframe_batch([object()])
    from lsd_slam_tpu_torch.mapping import MappingBackend
    threaded = SlamSystem(CAM, CFG, enable_slam=False, device="cpu")
    threaded.cfg = CFG.replace(system=SystemConfig(sequential=False))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        MappingBackend(threaded)
    vo = SlamSystem(CAM, CFG, enable_slam=False, device="cpu")
    img = np.zeros((128, 160), np.float32)
    assert vo.backend is None
    assert vo._attempt_relocalization(img, 0, 0.0) is None
