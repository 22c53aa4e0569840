"""Direct image-alignment tracking: the SE(3) odometry tracker."""

from lsd_slam_tpu_torch.tracking.reference import (  # noqa: F401
    TrackingRef, add_sim3_quads, make_tracking_ref)
from lsd_slam_tpu_torch.tracking.se3_tracker import (  # noqa: F401
    SE3Tracker, TrackResult)
