"""Carry state across from plain dicts of numpy arrays (JAX field names).

The depth-map state is this system's parameters: to feed the port the
exact state the JAX engine holds, a caller flattens each JAX value into a
dict keyed by its field names (tuples of levels become lists, missing
levels None) and builds the port's dataclasses here, on the CUDA device
unless the caller names another (`resolve_device`). Nothing in this
module knows the JAX package; it only reads dicts.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lsd_slam_tpu_torch import resolve_device
from lsd_slam_tpu_torch.config import (
    LSDConfig, TrackerConfig, DepthFilterConfig, KeyframeConfig,
    MappingConfig, SystemConfig)
from lsd_slam_tpu_torch.depth.state import DepthMapState
from lsd_slam_tpu_torch.frames.pyramid import FramePyramid, DepthPyramid
from lsd_slam_tpu_torch.mapping.pose_graph import PoseGraph
from lsd_slam_tpu_torch.tracking.reference import PointSet, TrackingRef

_CONFIG_FIELDS = dict(tracker=TrackerConfig, sim3_tracker=TrackerConfig,
                      depth=DepthFilterConfig, mapping=MappingConfig,
                      keyframe=KeyframeConfig, system=SystemConfig)

_STATE_DTYPES = dict(valid=torch.bool, blacklisted=torch.int32)


def _t(a, device, dtype=None):
    t = torch.as_tensor(np.asarray(a), device=resolve_device(device))
    return t if dtype is None else t.to(dtype)


def _levels(seq, device, dtype=None):
    return tuple(None if a is None else _t(a, device, dtype) for a in seq)


def config_from_dict(d: dict) -> LSDConfig:
    """LSDConfig from `dataclasses.asdict` of either package's config."""
    kw = {}
    for k, v in d.items():
        if k in _CONFIG_FIELDS:
            sub = dict(v)
            if "max_iterations" in sub:
                sub["max_iterations"] = tuple(sub["max_iterations"])
            kw[k] = _CONFIG_FIELDS[k](**sub)
        else:
            kw[k] = v
    return LSDConfig(**kw)


def depth_state_from_dict(d: dict, device=None) -> DepthMapState:
    kw = {f.name: _t(d[f.name], device,
                     _STATE_DTYPES.get(f.name, torch.float32))
          for f in dataclasses.fields(DepthMapState)}
    return DepthMapState(**kw)


def frame_pyramid_from_dict(d: dict, device=None) -> FramePyramid:
    f32 = torch.float32
    return FramePyramid(
        images=_levels(d["images"], device, f32),
        gx=_levels(d["gx"], device, f32),
        gy=_levels(d["gy"], device, f32),
        max_grad=_levels(d["max_grad"], device, f32),
        quad=_levels(d["quad"], device, f32),
        num_mappable=_t(d["num_mappable"], device, f32))


def depth_pyramid_from_dict(d: dict, device=None) -> DepthPyramid:
    return DepthPyramid(idepth=_levels(d["idepth"], device, torch.float32),
                        ivar=_levels(d["ivar"], device, torch.float32))


def point_set_from_dict(d: dict, device=None) -> PointSet:
    f32 = torch.float32
    return PointSet(
        idx=_t(d["idx"], device, torch.int64),
        ival=_t(d["ival"], device, f32), gx=_t(d["gx"], device, f32),
        gy=_t(d["gy"], device, f32), idp=_t(d["idp"], device, f32),
        ivr=_t(d["ivr"], device, f32), valid=_t(d["valid"], device,
                                                torch.bool),
        n_valid=_t(d["n_valid"], device, f32))


def tracking_ref_from_dict(d: dict, device=None) -> TrackingRef:
    """A TrackingRef, with its Sim3 target layouts where the dict has
    them (`sim3_quad`, None per level otherwise)."""
    pts = tuple(None if p is None else point_set_from_dict(p, device)
                for p in d["pts"])
    quads = d.get("sim3_quad") or (None,) * len(pts)
    return TrackingRef(pts=pts, sim3_quad=_levels(quads, device,
                                                  torch.float32))


def pose_graph_from_dict(d: dict, device=None) -> PoseGraph:
    """A PoseGraph from the JAX PoseGraph's host lists: `poses` (N, 8)
    camToWorld, `fixed` (N,), and per edge `e_from`, `e_to`, `e_meas_inv`
    (the inverse measurement, (E, 8)), `e_info` (E, 7, 7), `e_delta`."""
    g = PoseGraph(device=device)
    g.poses = [np.asarray(p, np.float64) for p in d["poses"]]
    g.fixed = [bool(f) for f in d["fixed"]]
    g.e_from = [int(i) for i in d["e_from"]]
    g.e_to = [int(i) for i in d["e_to"]]
    g.e_meas_inv = [np.asarray(m, np.float64) for m in d["e_meas_inv"]]
    g.e_info = [np.asarray(m, np.float64) for m in d["e_info"]]
    g.e_delta = [float(x) for x in d["e_delta"]]
    return g


def reactivation_from_dict(d: dict, device=None):
    """A keyframe's re-activation snapshot (Keyframe.reactivation): the
    tuple (idepth, var, validity) from a dict with those keys."""
    return tuple(_t(d[k], device, torch.float32)
                 for k in ("idepth", "var", "validity"))
