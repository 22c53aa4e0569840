"""Product IO: dataset input, trajectory logging, keyframe/graph output.

Port of lsd_slam_tpu/io (the reference's IOWrapper layer, src/IOWrapper/):
ROS pub/sub becomes file/npz streaming with the same wire design: points
stay in keyframe-local coordinates, only Sim3 poses are re-published on
graph updates (README.md:310-324).
"""

from lsd_slam_tpu_torch.io.trajectory import save_tum_trajectory  # noqa: F401
from lsd_slam_tpu_torch.io.output import (  # noqa: F401
    Output3DWrapper,
    FileOutput3DWrapper,
    export_ply,
)
from lsd_slam_tpu_torch.io.dataset import ImageFolderSource  # noqa: F401
