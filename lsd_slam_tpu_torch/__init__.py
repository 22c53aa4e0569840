"""lsd_slam_tpu_torch — the PyTorch/CUDA port of lsd_slam_tpu.

The JAX package (`lsd_slam_tpu`) stays the reference; this package mirrors
its sub-package and module names so every function has a findable
counterpart. Device state is plain dataclasses of torch tensors on an
explicit device; the one Pallas kernel of the JAX package (the 5x5
regularize stencil) is a hand-written CUDA C++ kernel for Hopper
(`csrc/regularize_stencil.cu`), built with nvcc at first use.

The port imports torch and numpy only — never jax, flax or anything under
`lsd_slam_tpu`. Entry points run on the CUDA device unless the caller
passes ``device="cpu"`` (as the CPU tests do); nothing falls back to the
CPU quietly.
"""

import torch

# The JAX trackers accumulate in f32 at Precision.HIGHEST; TF32 would drop
# ~13 mantissa bits of every matmul/convolution on the card.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# On the CPU, torch computes sqrt, exp, sin, cos, log ... of float tensors
# with MKL's vector math, which sets up its code path in its first call in
# the process. When ATen splits that first call over OpenMP threads, the
# threads that enter while the set-up runs were seen to compute their
# share to other last bits, and which ones do depends on timing: under
# load a CPU run of the port then leaves its bits from that call on (a
# 160x128 SLAM scenario: frame 0's gradient magnitude). One call small
# enough to stay on this thread makes the set-up happen first.
torch.sqrt(torch.ones(16))

__version__ = "0.1.0"

from lsd_slam_tpu_torch.config import LSDConfig  # noqa: E402,F401


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.

    Raises when no device is named and no CUDA device exists — a run that
    silently lands on the CPU would report CPU numbers as the card's."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device found; pass device=\"cpu\" to run the port "
                "on the CPU explicitly")
        return torch.device("cuda")
    return torch.device(device)
