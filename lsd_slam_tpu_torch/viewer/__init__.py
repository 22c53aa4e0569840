"""Offline map viewer: point-cloud rendering and camera-path animation.

Port of lsd_slam_tpu/viewer (numpy; images through utils.image_io).

Replaces the lsd_slam_viewer package (Qt/QGLViewer/OpenGL, SURVEY.md
section 2.8) with a headless software renderer: keyframe point clouds are
assembled with the same variance/support filters as KeyFrameDisplay::
refreshPC (KeyFrameDisplay.cpp:106-222), splatted through a z-buffer, and
written as PNGs; the animation helper interpolates a camera path over
keyframe poses like PointCloudViewer's fly-through system
(PointCloudViewer.cpp:178-298).
"""

from lsd_slam_tpu_torch.viewer.render import (  # noqa: F401
    MapRenderer,
    render_map_view,
    animate_camera_path,
)
