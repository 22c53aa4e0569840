"""Multi-device and multi-process scale-out (torch).

Port of lsd_slam_tpu/parallel/: the candidate quick-track batches sharded
over a device mesh, the edge-sharded pose-graph assembly and CG step, the
host channel, and the rank-0 frontend with its worker ranks. Importing
the package starts no process group and opens no socket.
"""

from lsd_slam_tpu_torch.parallel.distributed import (  # noqa: F401
    Mesh,
    make_mesh,
    default_mesh,
    pad_to_mesh,
    distributed_pgo_normal_equations,
    sharded_quick_track,
    sharded_quick_track_frames,
    distributed_pgo_step,
    distributed_pgo_cg_step,
)
