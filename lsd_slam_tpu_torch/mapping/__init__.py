"""Global mapping (torch): keyframe graph, Sim(3) constraints, pose-graph
optimiser — the port of lsd_slam_tpu/mapping in its sequential form."""

from lsd_slam_tpu_torch.mapping.backend import MappingBackend  # noqa: F401
