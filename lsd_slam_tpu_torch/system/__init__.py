"""Engine orchestration: poses, keyframes, the SlamSystem state machine."""

from lsd_slam_tpu_torch.system.poses import PoseNode  # noqa: F401
from lsd_slam_tpu_torch.system.keyframe import Keyframe  # noqa: F401
from lsd_slam_tpu_torch.system.slam_system import SlamSystem  # noqa: F401
from lsd_slam_tpu_torch.system.warmup import warmup  # noqa: F401
