"""The port's file formats and undistortion against Pillow and the JAX
package.

- Image codec (`utils.image_io`): equal to Pillow's decode bit for bit on
  files Pillow writes (gray, RGB, RGBA, gray+alpha; PGM/PPM; a palette
  PNG, which goes through Pillow),
  on one file per PNG row filter written by hand, on a batch of files
  with the filters mixed row by row (`read_gray_many`), and Pillow reads
  the port's PNGs back unchanged.
- Undistortion: the remap tables equal JAX's exactly (the parameter sets
  of tests/test_frames_camera.py:81-113 and a calibration file); the remap
  of a seeded 480x640 image within 1e-4 (0-255 values) of JAX's jitted
  `_remap_bilinear`; `remap_bilinear_cpu` equal to the JAX package's
  numpy path.
- Trajectory and PLY: the TUM round trip; `export_ply` and
  `write_ply_binary` of both packages give byte-identical files.
- `make_sequence`: the port's frames within 4e-3 of JAX's, as the other
  renders in tests/test_torch_modules.py.
"""

import struct
import zlib
from types import SimpleNamespace

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from lsd_slam_tpu.camera import undistort as jax_und
from lsd_slam_tpu.io import output as jax_output
from lsd_slam_tpu.io import trajectory as jax_traj
from lsd_slam_tpu.utils import native as jax_native
from lsd_slam_tpu.utils import synth as jax_synth

from lsd_slam_tpu_torch.camera import (Camera, undistorter_for_file,
                                       undistorter_for_params)
from lsd_slam_tpu_torch.camera import undistort
from lsd_slam_tpu_torch.io import output, trajectory
from lsd_slam_tpu_torch.utils import image_io, native, synth

REMAP_ATOL = 1e-4
RENDER_ATOL = 4e-3
FOV = [0.7, 0.9333, 0.5, 0.5, 0.9]
OPENCV = [0.7, 0.9333, 0.5, 0.5, -0.2, 0.05, 0.0, 0.0]
CASES = {
    "fov-crop": (FOV, "crop"),
    "fov-full": (FOV, "full"),
    "fov-none": (FOV, "none"),
    "fov-explicit": (FOV, [0.6, 0.8, 0.5, 0.5, 0.0]),
    "opencv-crop": (OPENCV, "crop"),
}
CALIB = "0.7 0.9333 0.5 0.5 0.9\n640 480\ncrop\n640 480\n"


def _smooth(rng, h, w, ch):
    """Smooth images with noise: Pillow's adaptive filtering then picks
    Up and Paeth rows."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = 128 + 60 * np.sin(xx / 7.0) + 50 * np.cos(yy / 5.0)
    planes = [base + 20 * k + rng.normal(0, 3, base.shape)
              for k in range(ch)]
    return np.clip(np.stack(planes, -1), 0, 255).astype(np.uint8)


# ------------------------------------------------------------------ codec

@pytest.mark.parametrize("mode,ch", [("L", 1), ("LA", 2), ("RGB", 3),
                                     ("RGBA", 4), ("P", 1)])
def test_png_read_equals_pillow(tmp_path, mode, ch):
    rng = np.random.default_rng(ch)
    arr = _smooth(rng, 97, 131, ch)
    if mode == "P":
        im = Image.fromarray(arr[..., 0]).convert("P")
    else:
        im = Image.fromarray(arr[..., 0] if ch == 1 else arr, mode)
    path = str(tmp_path / f"{mode}.png")
    im.save(path)
    for conv, read in (("L", image_io.read_gray), ("RGB", image_io.read_rgb)):
        want = np.asarray(Image.open(path).convert(conv))
        got = read(path)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


def _png_with_filter(rows: np.ndarray, ftype, color: int) -> bytes:
    """PNG bytes whose rows use filter `ftype` (one for every row, or one
    per row; the PNG spec's encoders, section 9.2), from (h, w, c)
    uint8."""
    h, w, c = rows.shape
    raw = rows.reshape(h, w * c).astype(np.int64)
    out = np.zeros((h, 1 + w * c), np.uint8)
    out[:, 0] = ftype
    for y in range(h):
        ftype = int(out[y, 0])
        prior = raw[y - 1] if y else np.zeros(w * c, np.int64)
        for i in range(w * c):
            a = raw[y, i - c] if i >= c else 0
            b = prior[i]
            cc = prior[i - c] if i >= c else 0
            p = a + b - cc
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
            paeth = a if pa <= pb and pa <= pc else (b if pb <= pc else cc)
            pred = (0, a, b, (a + b) // 2, paeth)[ftype]
            out[y, 1 + i] = (raw[y, i] - pred) & 0xFF

    def chunk(t, body):
        return (struct.pack(">I", len(body)) + t + body
                + struct.pack(">I", zlib.crc32(t + body) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(out.tobytes()))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_png_every_row_filter(tmp_path, ftype):
    rng = np.random.default_rng(10 + ftype)
    arr = rng.integers(0, 256, (9, 13, 3)).astype(np.uint8)
    path = tmp_path / f"f{ftype}.png"
    path.write_bytes(_png_with_filter(arr, ftype, 2))
    np.testing.assert_array_equal(np.asarray(Image.open(path)), arr)
    np.testing.assert_array_equal(image_io.read_rgb(str(path)), arr)
    np.testing.assert_array_equal(
        image_io.read_gray(str(path)),
        np.asarray(Image.open(path).convert("L")))


def test_read_gray_many_equals_pillow(tmp_path):
    """A batch as the runner reads it: gray files with every row filter in
    a random order per row (decoded together), a gray file of filter 0
    only, an RGB and a gray+alpha file of the same size, a gray file of
    another size and a PGM, each equal to Pillow's `convert("L")`."""
    rng = np.random.default_rng(21)
    paths = []
    for k in range(3):
        arr = _smooth(rng, 24, 29, 1)
        paths.append(tmp_path / f"g{k}.png")
        paths[-1].write_bytes(_png_with_filter(
            arr, rng.integers(0, 5, 24), 0))
    paths.append(tmp_path / "zero.png")
    image_io.write_png(str(paths[-1]), _smooth(rng, 24, 29, 1)[..., 0])
    for name, ch, color in (("rgb", 3, 2), ("la", 2, 4)):
        paths.append(tmp_path / f"{name}.png")
        paths[-1].write_bytes(_png_with_filter(
            _smooth(rng, 24, 29, ch), rng.integers(0, 5, 24), color))
    paths.append(tmp_path / "small.png")
    paths[-1].write_bytes(_png_with_filter(_smooth(rng, 11, 7, 1),
                                           rng.integers(0, 5, 11), 0))
    paths.append(tmp_path / "x.pgm")
    Image.fromarray(_smooth(rng, 24, 29, 1)[..., 0]).save(paths[-1])
    got = image_io.read_gray_many([str(p) for p in paths])
    assert len(got) == len(paths)
    for p, g in zip(paths, got):
        np.testing.assert_array_equal(
            g, np.asarray(Image.open(p).convert("L")), err_msg=p.name)
        np.testing.assert_array_equal(g, image_io.read_gray(str(p)))


@pytest.mark.parametrize("mode,ext", [("L", "pgm"), ("RGB", "ppm")])
def test_pnm_read_equals_pillow(tmp_path, mode, ext):
    rng = np.random.default_rng(3)
    shape = (20, 30) if mode == "L" else (20, 30, 3)
    path = str(tmp_path / f"x.{ext}")
    Image.fromarray(rng.integers(0, 256, shape).astype(np.uint8),
                    mode).save(path)
    for conv, read in (("L", image_io.read_gray), ("RGB", image_io.read_rgb)):
        np.testing.assert_array_equal(read(path), np.asarray(
            Image.open(path).convert(conv)))


@pytest.mark.parametrize("ch", [1, 3, 4])
def test_written_png_reads_back_in_pillow(tmp_path, ch):
    rng = np.random.default_rng(ch)
    arr = rng.integers(0, 256, (17, 23, ch)).astype(np.uint8)
    if ch == 1:
        arr = arr[..., 0]
    path = str(tmp_path / "w.png")
    image_io.write_png(path, arr)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), arr)
    np.testing.assert_array_equal(image_io.read_gray(path), np.asarray(
        Image.open(path).convert("L")))


def test_other_formats_name_the_file_and_pillow(tmp_path, monkeypatch):
    """A JPEG goes through Pillow when it imports; without Pillow the
    error names the file and Pillow."""
    path = str(tmp_path / "x.jpg")
    arr = _smooth(np.random.default_rng(0), 16, 16, 3)
    Image.fromarray(arr).save(path)
    np.testing.assert_array_equal(image_io.read_gray(path), np.asarray(
        Image.open(path).convert("L")))
    import builtins
    real_import = builtins.__import__

    def no_pil(name, *a, **k):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no Pillow here")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(ValueError, match=r"x\.jpg.*Pillow"):
        image_io.read_gray(path)


# ------------------------------------------------------------ undistortion

def _both(case, tmp_path=None):
    if case == "file":
        path = tmp_path / "calib.cfg"
        path.write_text(CALIB)
        return (undistorter_for_file(str(path), device="cpu"),
                jax_und.undistorter_for_file(str(path)))
    params, spec = CASES[case]
    return (undistorter_for_params(params, (640, 480), spec, (640, 480),
                                   device="cpu"),
            jax_und.undistorter_for_params(params, (640, 480), spec,
                                           (640, 480)))


@pytest.mark.parametrize("case", [*CASES, "file"])
def test_undistorter_tables_equal_jax(case, tmp_path):
    port, ref = _both(case, tmp_path)
    assert port.camera == Camera(*[getattr(ref.camera, f) for f in (
        "fx", "fy", "cx", "cy", "width", "height")])
    assert port._identity == ref._identity
    assert port._rx.device.type == "cpu"
    for name in ("_rx", "_ry", "_valid"):
        a, b = getattr(port, name).numpy(), np.asarray(getattr(ref, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("case", ["fov-crop", "fov-full", "opencv-crop"])
def test_remap_matches_jax(case):
    port, ref = _both(case)
    img = np.random.default_rng(0).uniform(0, 255, (480, 640)).astype(
        np.float32)
    got = port(img)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    want = np.asarray(jax_und._remap_bilinear(
        jnp.asarray(img), ref._rx, ref._ry, ref._valid))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=REMAP_ATOL)


def test_identity_undistorter_passes_the_image_through():
    port, _ = _both("fov-none")
    img = np.random.default_rng(1).uniform(0, 255, (480, 640)).astype(
        np.float32)
    assert port._identity
    np.testing.assert_array_equal(port(img).numpy(), img)


def test_cpu_remap_equals_jax_numpy_path(monkeypatch):
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 255, (48, 64)).astype(np.float32)
    rx = rng.uniform(-2, 66, (40, 50)).astype(np.float32)
    ry = rng.uniform(-2, 50, (40, 50)).astype(np.float32)
    # the JAX package's numpy path, not its native library
    monkeypatch.setattr(jax_native, "_LIB", False)
    np.testing.assert_array_equal(native.remap_bilinear_cpu(img, rx, ry),
                                  jax_native.remap_bilinear_cpu(img, rx, ry))


def test_cpu_remap_and_device_remap_keep_their_border_rules(monkeypatch):
    """remap_bilinear_cpu clips x0 to w-2; the undistorter's remap clips
    x0+1 to w-1: at the last column they differ, as in the JAX package."""
    img = np.arange(12, dtype=np.float32).reshape(3, 4)
    rx = np.array([[3.0]], np.float32)
    ry = np.array([[1.0]], np.float32)
    host = native.remap_bilinear_cpu(img, rx, ry)
    dev = undistort._remap_bilinear(torch.as_tensor(img), torch.as_tensor(rx),
                                    torch.as_tensor(ry),
                                    torch.ones(1, 1, dtype=torch.bool))
    assert host[0, 0] == img[1, 3] and dev[0, 0] == img[1, 3]
    rx = np.array([[3.5]], np.float32)
    monkeypatch.setattr(jax_native, "_LIB", False)
    host = native.remap_bilinear_cpu(img, rx, ry)
    dev = undistort._remap_bilinear(torch.as_tensor(img), torch.as_tensor(rx),
                                    torch.as_tensor(ry),
                                    torch.ones(1, 1, dtype=torch.bool))
    np.testing.assert_array_equal(host, jax_native.remap_bilinear_cpu(
        img, rx, ry))
    assert host[0, 0] != dev[0, 0]


# --------------------------------------------------------- trajectory, PLY

def test_tum_trajectory_roundtrip(tmp_path):
    rng = np.random.default_rng(4)
    traj = []
    for i in range(7):
        q = rng.normal(size=4)
        traj.append((i / 30.0, i, np.concatenate(
            [q / np.linalg.norm(q), rng.normal(size=3), [1.0]])))
    a, b = tmp_path / "port.txt", tmp_path / "jax.txt"
    trajectory.save_tum_trajectory(str(a), traj)
    jax_traj.save_tum_trajectory(str(b), traj)
    assert a.read_bytes() == b.read_bytes()
    loaded = trajectory.load_tum_trajectory(str(a))
    assert loaded.shape == (7, 8)
    np.testing.assert_allclose(loaded[:, 0], [t for t, _, _ in traj],
                               atol=1e-6)
    np.testing.assert_allclose(loaded[:, 1:4], [p[4:7] for _, _, p in traj],
                               atol=1e-6)
    np.testing.assert_allclose(loaded[:, 7], [p[0] for _, _, p in traj],
                               atol=1e-6)


def _stand_in_keyframes(as_tensor):
    """Keyframe stand-ins: level-0 idepth, ivar and image, and a Sim(3)
    pose; numpy for JAX, tensors for the port."""
    rng = np.random.default_rng(5)
    kfs = []
    for k in range(3):
        h, w = 48, 64
        idepth = rng.uniform(0.3, 0.7, (h, w)).astype(np.float32)
        idepth[rng.random((h, w)) < 0.3] = 0.0
        ivar = np.where(idepth > 0, rng.uniform(1e-4, 3e-2, (h, w)),
                        -1.0).astype(np.float32)
        image = rng.uniform(-5, 260, (h, w)).astype(np.float32)
        c2w = np.array([np.cos(0.1 * k), 0, np.sin(0.1 * k), 0,
                        0.2 * k, 0.05, -0.1 * k, 1.0 + 0.1 * k])
        wrap = (lambda a: torch.as_tensor(a)) if as_tensor else (lambda a: a)
        kfs.append(SimpleNamespace(
            depth=SimpleNamespace(idepth=[wrap(idepth)], ivar=[wrap(ivar)]),
            pyr=SimpleNamespace(images=[wrap(image)]),
            pose=SimpleNamespace(cam_to_world=lambda c=c2w: c.copy())))
    return kfs


@pytest.mark.parametrize("jax_path", ["numpy", "library"])
def test_ply_files_are_byte_identical(tmp_path, monkeypatch, jax_path):
    """Against the JAX package's numpy writer and, where it is built,
    its native one."""
    if jax_path == "numpy":
        monkeypatch.setattr(jax_native, "_LIB", False)
    elif not jax_native.have_native():
        pytest.skip("the JAX package's native library is not built")
    cam = Camera(fx=50.0, fy=50.0, cx=31.5, cy=23.5, width=64, height=48)
    a, b = str(tmp_path / "port.ply"), str(tmp_path / "jax.ply")
    n_port = output.export_ply(a, _stand_in_keyframes(True), cam)
    n_jax = jax_output.export_ply(b, _stand_in_keyframes(False), cam)
    assert n_port == n_jax > 100
    assert open(a, "rb").read() == open(b, "rb").read()
    rng = np.random.default_rng(6)
    xyz = rng.normal(size=(11, 3)).astype(np.float32)
    rgb = rng.integers(0, 256, (11, 3)).astype(np.uint8)
    native.write_ply_binary(a, xyz, rgb)
    jax_native.write_ply_binary(b, xyz, rgb)
    assert open(a, "rb").read() == open(b, "rb").read()


def test_make_sequence_matches_jax():
    cam, imgs, deps, poses = synth.make_sequence(n_frames=3, width=64,
                                                 height=48, seed=2,
                                                 device="cpu")
    jcam, jimgs, jdeps, jposes = jax_synth.make_sequence(n_frames=3,
                                                         width=64, height=48,
                                                         seed=2)
    assert (cam.fx, cam.cx, cam.width) == (jcam.fx, jcam.cx, jcam.width)
    assert imgs.shape == (3, 48, 64) and imgs.device.type == "cpu"
    np.testing.assert_allclose(poses, jposes, atol=1e-6)
    np.testing.assert_allclose(imgs.numpy(), jimgs, atol=RENDER_ATOL)
    np.testing.assert_allclose(deps.numpy(), jdeps, atol=1e-5)
