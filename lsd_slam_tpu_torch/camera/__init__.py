"""Camera model, calibration parsing and undistortion.

Port of lsd_slam_tpu/camera: remap tables are built once on the host
(numpy) and undistortion runs as a bilinear gather on the undistorter's
device (torch ops).
"""

from lsd_slam_tpu_torch.camera.model import Camera  # noqa: F401
from lsd_slam_tpu_torch.camera.undistort import (  # noqa: F401
    Undistorter,
    make_fov_undistorter,
    make_opencv_undistorter,
    undistorter_for_file,
    undistorter_for_params,
)
