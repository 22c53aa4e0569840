"""Camera model (pinhole with the reference's pyramid-level convention)."""

from lsd_slam_tpu_torch.camera.model import Camera  # noqa: F401
