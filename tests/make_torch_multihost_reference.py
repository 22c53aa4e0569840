"""Write the JAX engine's reference that tests/test_torch_multihost.py's
two-process engine test holds the port to.

The run is the one tests/multihost_engine_worker.py's `run_engine(None)`
makes: the JAX engine in one process on the 30 frames that file's
`make_sequence()` renders (160x128, PlaneScene(seed=13)), with its keyframe
settings. The keyframe count, the edge count, the (30, 8) trajectory and a
SHA-256 of the rendered images and depths go to
lsd_slam_tpu_torch/reference_data/multihost_engine_160x128.json. The test
renders the frames again in a child (`tests/_torch_multihost_worker.py
jax-frames`, seconds), checks their hashes against the file, and runs the
port's two ranks on them, so a changed renderer fails loudly instead of
comparing different inputs.

    env JAX_PLATFORMS=cpu PYTHONPATH=. timeout 900 \\
        python tests/make_torch_multihost_reference.py

The JAX engine takes minutes on a few cores; run one JAX process at a
time. With --check-jax it instead runs the JAX engine again and prints
its differences from the stored file (outside the tests, as
tests/make_torch_slam_reference.py's --check-jax). XLA_FLAGS is cleared
before JAX starts, so the engine sees one CPU device, as the test's child
process used to.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "lsd_slam_tpu_torch", "reference_data",
                   "multihost_engine_160x128.json")


def frames_sha256(imgs, deps) -> dict:
    """SHA-256 of the stacked frames as little-endian f32, images and
    depths apart."""
    return {name: hashlib.sha256(np.ascontiguousarray(
        np.stack(list(x)), dtype="<f4").tobytes()).hexdigest()
        for name, x in (("imgs_sha256", imgs), ("deps_sha256", deps))}


def run_jax() -> dict:
    from tests.multihost_engine_worker import make_sequence, run_engine

    _, imgs, deps, _ = make_sequence()
    t0 = time.time()
    traj, n_kf, n_edges, _ = run_engine(multihost=None)
    return dict(n_kf=int(n_kf), n_edges=int(n_edges),
                traj=np.asarray(traj, np.float64).tolist(),
                seconds=time.time() - t0, **frames_sha256(imgs, deps))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check-jax", action="store_true",
                    help="run the JAX engine again and print its "
                    "differences from the stored file")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args()
    os.environ.pop("XLA_FLAGS", None)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, ROOT)
    got = run_jax()
    if args.check_jax:
        with open(args.out) as f:
            ref = json.load(f)
        a, b = np.asarray(got["traj"]), np.asarray(ref["traj"])
        print(json.dumps(dict(
            n_kf=[got["n_kf"], ref["n_kf"]],
            n_edges=[got["n_edges"], ref["n_edges"]],
            same_frames=all(got[k] == ref[k] for k in
                            ("imgs_sha256", "deps_sha256")),
            max_position_diff=float(np.linalg.norm(
                a[:, 4:7] - b[:, 4:7], axis=1).max()),
            seconds=got["seconds"])))
        return 0
    ref = {k: v for k, v in got.items() if k != "seconds"}
    with open(args.out, "w") as f:
        json.dump(ref, f)
    print(json.dumps({k: v for k, v in got.items() if k != "traj"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
