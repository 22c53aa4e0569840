"""Rules of the port: it never loads JAX, a CUDA tensor never takes a plain
version, and nothing falls back to the CPU quietly."""

import dataclasses
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from lsd_slam_tpu_torch import interop
from lsd_slam_tpu_torch.camera import Camera, undistorter_for_params
from lsd_slam_tpu_torch.config import LSDConfig, SystemConfig
from lsd_slam_tpu_torch.depth.state import DepthMapState
from lsd_slam_tpu_torch.io.live import LiveSLAMWrapper
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
print("SWEPT", sorted(n for n in sys.modules
                      if n.startswith("lsd_slam_tpu_torch.")))
"""
# the product surface, which the sweep must reach
PRODUCT_MODULES = ("io.runner", "io.dataset", "io.output", "io.checkpoint",
                   "io.live", "io.dump", "io.trajectory", "viewer.render",
                   "viewer.live", "viewer.stitch", "camera.undistort",
                   "utils.image_io", "utils.debug_viz")
# the order-fixed scatter-sum and the modules built on it, and warm-up
BACKEND_MODULES = ("ops.scatter", "mapping.sparse_pgo", "mapping.appearance",
                   "system.warmup")

_IMPORT_RUNNER = r"""
import sys
before = set(sys.modules)
import lsd_slam_tpu_torch.io.runner, lsd_slam_tpu_torch.io.dataset
print("PIL", sorted(n for n in set(sys.modules) - before
                    if n.split(".")[0] == "PIL"))
"""


def test_importing_the_port_loads_no_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    swept = out.stdout.split("SWEPT", 1)[1]
    for name in PRODUCT_MODULES + BACKEND_MODULES:
        assert f"'lsd_slam_tpu_torch.{name}'" in swept, name


def test_runner_and_dataset_load_no_pillow():
    """The card's machine has no Pillow: the runner and the dataset reader
    import none (PNG and PGM/PPM decode in utils.image_io)."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _IMPORT_RUNNER], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "PIL []" in out.stdout, out.stdout


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
                                   "pose_graph_from_dict", "reactivation",
                                   "make_sequence", "undistorter",
                                   "live_wrapper"])
def test_entry_points_without_device_raise_without_cuda(monkeypatch, entry):
    """The state carried across, the synthetic renderer, the undistorter
    and the live wrapper run on the card unless the caller names a device;
    without one they raise."""
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
        "make_sequence": lambda: synth.make_sequence(2, 32, 24),
        "undistorter": lambda: undistorter_for_params(
            [0.7, 0.9333, 0.5, 0.5, 0.9], (64, 48), "crop", (64, 48)),
        "live_wrapper": lambda: LiveSLAMWrapper(CAM, CFG),
    }
    with pytest.raises(RuntimeError, match='device="cpu"'):
        calls[entry]()


def test_slam_system_runs_where_asked():
    sys_ = SlamSystem(CAM, CFG, device="cpu")
    assert sys_.device.type == "cpu"
    assert sys_.map.device.type == "cpu"


@pytest.mark.parametrize("kw", [
    dict(cfg=CFG.replace(system=SystemConfig(use_fabmap=True))),
    dict(cfg=CFG.replace(system=SystemConfig(use_fabmap=True)), graph=True),
    dict(cfg=CFG, pgo_vertices=PoseGraph.dense_threshold + 1),
    dict(argv=["files:/d", "calib:/c.cfg", "multihost:0:2"]),
])
def test_unported_modes_raise(kw):
    """The modes that raised before they were ported: the runner's
    `multihost:` still raises, naming its ROADMAP item; the appearance
    index (in SlamSystem, and in the keyframe graph of a VO engine) now
    builds, and a pose graph above the dense threshold now takes the
    sparse solver and returns."""
    from lsd_slam_tpu_torch.mapping.appearance import AppearanceIndex
    if "argv" in kw:
        from lsd_slam_tpu_torch.io import runner
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            runner.main(kw["argv"])
    elif "pgo_vertices" in kw:
        pg = PoseGraph(device="cpu")
        for _ in range(kw["pgo_vertices"]):
            pg.add_vertex(np.array([1, 0, 0, 0, 0, 0, 0, 1.0]))
        pg.add_edge(0, 1, np.array([1, 0, 0, 0, 0, 0, 0, 1.0]),
                    np.eye(7), 1.0)
        assert pg.optimize(1) == 0.0 and len(pg.cg_iters) == 1
    elif kw.get("graph"):
        from lsd_slam_tpu_torch.mapping.keyframe_graph import KeyFrameGraph
        graph = KeyFrameGraph(SlamSystem(CAM, kw["cfg"], enable_slam=False,
                                         device="cpu"))
        assert isinstance(graph.appearance, AppearanceIndex)
    else:
        sys_ = SlamSystem(CAM, kw["cfg"], device="cpu")
        assert isinstance(sys_.backend.graph.appearance, AppearanceIndex)


@pytest.mark.parametrize("sequential", [True, False])
@pytest.mark.parametrize("lag", [0, 2, 3])
def test_concurrent_modes_construct_and_finalize(sequential, lag):
    """Every sequential x pipeline_lag combination builds; the mapping
    thread runs only threaded at lag 0, the back-end's threads whenever
    threaded, and finalize stops them all."""
    cfg = CFG.replace(system=SystemConfig(sequential=sequential,
                                          pipeline_lag=lag))
    sys_ = SlamSystem(CAM, cfg, device="cpu")
    assert sys_._lag == lag
    assert (sys_.mapping_thread is not None) == (not sequential and lag == 0)
    assert len(sys_.backend.workers()) == (0 if sequential else 2)
    assert all(w.alive() for w in sys_.workers())
    sys_.finalize()
    assert not any(w.alive() for w in sys_.workers())


def test_unported_mapping_paths_raise():
    """The mapping paths that once raised work now: the queue-drain mapping
    (`update_keyframe_batch`, `update_keyframe`) with nothing to map
    returns False, the threaded back-end starts its threads; VO mode has no
    relocaliser (it returns at once, as in JAX)."""
    sys_ = SlamSystem(CAM, CFG, device="cpu")
    assert sys_.update_keyframe_batch([]) is False
    assert sys_.update_keyframe() is False
    from lsd_slam_tpu_torch.mapping import MappingBackend
    threaded = SlamSystem(CAM, CFG, enable_slam=False, device="cpu")
    threaded.cfg = CFG.replace(system=SystemConfig(sequential=False))
    backend = MappingBackend(threaded)
    assert [w.name for w in backend.workers()] == ["lsd-constraints",
                                                   "lsd-optimization"]
    backend.stop_threads()
    assert not any(w.alive() for w in backend.workers())
    vo = SlamSystem(CAM, CFG, enable_slam=False, device="cpu")
    img = np.zeros((128, 160), np.float32)
    assert vo.backend is None
    assert vo._attempt_relocalization(img, 0, 0.0) is None


def test_kernel_library_loads_once_across_threads(monkeypatch, tmp_path):
    """Two threads' first use of a kernel library builds it once and load
    it once (ops/build.py's lock); the build is stubbed, so no nvcc."""
    from lsd_slam_tpu_torch.ops import build

    builds = []
    start = threading.Barrier(2)
    lib_path = tmp_path / "libfake.so"

    def fake_build(names):
        builds.append(list(names))
        time.sleep(0.2)           # a slow nvcc: the other thread waits
        lib_path.write_bytes(b"")

    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(build, "build", fake_build)
    monkeypatch.setattr(build, "library_path", lambda name: lib_path)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: ("lib", path))
    got = []

    def first_use():
        start.wait(30.0)
        got.append(build.load("regularize_stencil"))

    threads = [threading.Thread(target=first_use) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30.0)
    assert builds == [["regularize_stencil"]]
    assert len(got) == 2 and got[0] is got[1]


def test_launch_counter_keeps_every_count_across_threads(monkeypatch):
    """The launch counters are bumped under a lock: no count is lost when
    more threads than cores launch at once with a short switch interval
    (the launch itself is stubbed)."""
    monkeypatch.setattr(stencil, "_cuda_or_plain", lambda name, t: True)
    monkeypatch.setattr(stencil, "_check", lambda *a, **k: None)
    monkeypatch.setattr(stencil, "_launch", lambda *a, **k: None)
    monkeypatch.setattr(stencil, "FUSED_LAUNCHES", 0)
    f32 = torch.zeros(4, 4)
    args = (f32, f32, f32 > 0, f32, f32, f32,
            torch.zeros(4, 4, dtype=torch.int32), 0.005625, 1.0, 24.0, False)

    def launch_many():
        for _ in range(500):
            stencil.regularize_fused(*args)

    n_threads = 2 * (os.cpu_count() or 4)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=launch_many)
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert stencil.FUSED_LAUNCHES == 500 * n_threads
