"""Semi-dense inverse-depth filtering (the mapping back-end) in torch."""

from lsd_slam_tpu_torch.depth.state import DepthMapState  # noqa: F401
from lsd_slam_tpu_torch.depth.depth_map import DepthMap  # noqa: F401
