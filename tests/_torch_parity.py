"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

The JAX and torch packages exchange values only as numpy arrays: a JAX
dataclass value is flattened into a dict keyed by its field names (tuples
of levels become lists) and handed to `lsd_slam_tpu_torch.interop`.
"""

import dataclasses

import numpy as np
import torch


def to_dict(value):
    """Flatten a JAX pytree dataclass (or tuple / array / None) to numpy."""
    if value is None:
        return None
    if dataclasses.is_dataclass(value):
        return {f.name: to_dict(getattr(value, f.name))
                for f in dataclasses.fields(value)}
    if isinstance(value, (tuple, list)):
        return [to_dict(v) for v in value]
    return np.asarray(value)


def np_(t):
    """A torch tensor (or nested dataclass/tuple of them) as numpy."""
    if t is None:
        return None
    if torch.is_tensor(t):
        return t.detach().cpu().numpy()
    if dataclasses.is_dataclass(t):
        return {f.name: np_(getattr(t, f.name)) for f in dataclasses.fields(t)}
    if isinstance(t, (tuple, list)):
        return [np_(v) for v in t]
    return np.asarray(t)
