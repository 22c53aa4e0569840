"""Frame pyramid containers and builders (eager whole-pyramid build)."""

from lsd_slam_tpu_torch.frames.pyramid import (  # noqa: F401
    FramePyramid,
    DepthPyramid,
    build_frame,
    build_depth_pyramid,
    num_levels,
)
