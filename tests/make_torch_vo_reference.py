"""Write the JAX reference trajectory that `chip_smoke.py` holds the port to.

Runs the JAX engine (lsd_slam_tpu) on the CPU over the chip smoke sequence —
640x480, default LSDConfig(), PlaneScene(seed=7), orbit_trajectory(N,
radius=0.06, fwd=0.01), gt_depth_init then track_frame for N-1 frames and
finalize — and writes the trajectory, the keyframe ids and the ATE to
lsd_slam_tpu_torch/reference_data/vo_orbit_640x480.json.

    env JAX_PLATFORMS=cpu PYTHONPATH=. python tests/make_torch_vo_reference.py

The run must create at least one keyframe (exit 1 otherwise).

With --check-port it instead runs the port (lsd_slam_tpu_torch) on the CPU
over the same sequence, rendered by the port's own synth as chip_smoke.py
does, and prints its per-frame difference from the stored reference;
with --check-port --frames N it runs the orbit of N frames and prints the
per-frame keyframe and tracking state only.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "lsd_slam_tpu_torch", "reference_data",
                   "vo_orbit_640x480.json")
W, H = 640, 480
SCENE_SEED, RADIUS, FWD = 7, 0.06, 0.01


def rotation_angle(qa, qb):
    """Angle (rad) of the relative rotation between unit quaternions."""
    d = abs(float(np.dot(qa, qb)) / (np.linalg.norm(qa) * np.linalg.norm(qb)))
    return 2.0 * np.arccos(min(d, 1.0))


def run_jax(n_frames: int):
    # the JAX engine's on-disk program cache lives under $HOME; this
    # one-off run needs none
    os.environ.setdefault("LSD_AOT_CACHE", "0")
    import jax.numpy as jnp
    from lsd_slam_tpu.config import LSDConfig
    from lsd_slam_tpu.system import SlamSystem
    from lsd_slam_tpu.utils import synth
    from lsd_slam_tpu.utils.evaluate import ate_rmse

    cam = synth.default_camera(W, H)
    scene = synth.PlaneScene(seed=SCENE_SEED)
    poses = synth.orbit_trajectory(n_frames, radius=RADIUS, fwd=FWD)
    sys_ = SlamSystem(cam, LSDConfig(), enable_slam=False)
    for i in range(n_frames):
        img, dep = synth.render(scene, cam, jnp.asarray(poses[i]))
        if i == 0:
            sys_.gt_depth_init(np.asarray(img), np.asarray(dep), 0, 0.0)
        else:
            sys_.track_frame(np.asarray(img), i, i / 30.0)
    sys_.finalize()
    traj = sys_.trajectory_array()
    return dict(
        n_frames=n_frames, width=W, height=H, scene_seed=SCENE_SEED,
        radius=RADIUS, fwd=FWD,
        frame_ids=[int(f) for _, f, _ in sys_.trajectory],
        keyframe_ids=[int(kf.id) for kf in sys_.keyframes],
        keyframes_created=int(sys_.stats.snapshot().get(
            "keyframes_created", 0)),
        tracking_is_good=bool(sys_.tracking_is_good),
        ate=float(ate_rmse(traj, poses)),
        trajectory_c2w_sim3=np.asarray(traj, np.float64).tolist(),
    )


def check_port(ref: dict, n_frames: int = 0):
    """Run the port over the reference sequence (or over the orbit of
    `n_frames` frames) and print, per frame, the current keyframe, its
    depth points and the tracking flag; then, for the reference sequence,
    the difference from the stored trajectory."""
    import torch
    from lsd_slam_tpu_torch.config import LSDConfig
    from lsd_slam_tpu_torch.system import SlamSystem
    from lsd_slam_tpu_torch.utils import synth
    from lsd_slam_tpu_torch.utils.evaluate import ate_rmse

    n = n_frames or ref["n_frames"]
    cam = synth.default_camera(W, H)
    scene = synth.PlaneScene(seed=SCENE_SEED)
    poses = synth.orbit_trajectory(n, radius=RADIUS, fwd=FWD)
    sys_ = SlamSystem(cam, LSDConfig(), device="cpu")
    t0 = time.time()
    for i in range(n):
        img, dep = synth.render(scene, cam, poses[i])
        if i == 0:
            sys_.gt_depth_init(img, dep, 0, 0.0)
        else:
            sys_.track_frame(img, i, i / 30.0)
        kf = sys_.current_keyframe
        print(json.dumps(dict(frame=i, keyframe=int(kf.id),
                              keyframe_points=kf.num_points,
                              point_share=kf.num_points / (W * H),
                              tracking_is_good=sys_.tracking_is_good)))
    sys_.finalize()
    traj = sys_.trajectory_array()
    out = dict(seconds=time.time() - t0, torch=torch.__version__,
               frames_logged=len(traj),
               keyframe_ids=[int(kf.id) for kf in sys_.keyframes],
               ref_keyframe_ids=ref["keyframe_ids"])
    if n == ref["n_frames"]:
        jref = np.asarray(ref["trajectory_c2w_sim3"])
        dc = np.linalg.norm(traj[:, 4:7] - jref[:, 4:7], axis=1)
        da = [rotation_angle(a[0:4], b[0:4]) for a, b in zip(traj, jref)]
        out.update(ate=float(ate_rmse(traj, poses)), ref_ate=ref["ate"],
                   max_centre_diff=float(dc.max()),
                   max_rot_diff=float(max(da)),
                   centre_diff=[float(x) for x in dc])
    print(json.dumps(out))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    # N = 9 ends on the first keyframe switch (frame 8): at 640x480 on this
    # scene the JAX engine diverges on the frame after its first switch,
    # whatever N (tried 12, 20, 40, 60), and VO mode cannot relocalise
    ap.add_argument("--frames", type=int, default=0,
                    help="orbit length (default: 9, or the stored "
                         "reference's with --check-port)")
    ap.add_argument("--check-port", action="store_true")
    args = ap.parse_args()
    if args.check_port:
        with open(OUT) as f:
            check_port(json.load(f), args.frames)
        return 0
    ref = run_jax(args.frames or 9)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(ref, f, indent=1)
    print(json.dumps({k: v for k, v in ref.items()
                      if k != "trajectory_c2w_sim3"}))
    return 0 if ref["keyframes_created"] >= 1 else 1


if __name__ == "__main__":
    sys.exit(main())
