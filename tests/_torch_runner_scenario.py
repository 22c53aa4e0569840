"""The dataset runs of tests/test_torch_runner.py, by one engine in a fresh
process.

    python tests/_torch_runner_scenario.py ENGINE FILES CALIB OUT DRAW.npy [THREADS]

ENGINE is `jax` (lsd_slam_tpu.io.runner) or `port`
(lsd_slam_tpu_torch.io.runner, `device:cpu`). Each runs the image folder
FILES twice through its runner's `main`: `vo` into OUT/vo, SLAM into
OUT/slam. The runner starts from `random_init`, whose draw differs
between the packages by design (a jax.random key against a
torch.Generator); the port's run takes JAX's draw instead, from DRAW.npy,
by patching `DepthMap.initialize_randomly` in this process only. Its torch
threads are pinned, as in tests/_torch_slam_scenario.py: to THREADS if
given (how far runs that differ only in rounding spread), else 8.
"""

from __future__ import annotations

import os
import sys

PORT_THREADS = 8


def main(engine, files, calib, out, draw_path, threads=PORT_THREADS):
    runs = (("vo", ["vo"]), ("slam", []))
    if engine == "jax":
        from lsd_slam_tpu.io import runner
        extra = []
    else:
        import numpy as np
        import torch

        from lsd_slam_tpu_torch.depth import depth_map
        from lsd_slam_tpu_torch.io import runner

        torch.set_num_threads(int(threads))
        draw = np.load(draw_path)

        def jax_draw(self, kf_max_grad, seed=0):
            self.state = depth_map.init_random(
                torch.as_tensor(draw, device=self.device), kf_max_grad,
                self.cfg)
            self._reset_counts()

        depth_map.DepthMap.initialize_randomly = jax_draw
        extra = ["device:cpu"]
    for name, flags in runs:
        runner.main([f"files:{files}", f"calib:{calib}",
                     f"out:{os.path.join(out, name)}", *flags, *extra])


if __name__ == "__main__":
    main(*sys.argv[1:7])
