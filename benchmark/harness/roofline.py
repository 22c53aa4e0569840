"""The card's peaks and the shape-only bounds of the port's kernels.

Copied at commit 30445d6 from `chip_smoke.py`: the peaks
(`HBM_BYTES_PER_S`, `F32_FLOP_PER_S`, lines 409-410), `bound` (5214-5218,
the byte and operation bound of a per-pixel kernel; the fused stencil is
`bound(38, 25 * 12 + 10)` at line 5549) and `epl_bounds` (2403-2427, of
which the set-up's and the fusion's bytes are shape-only). The peaks are
NVIDIA's data sheet for one H100 SXM at its 700 W limit: HBM3 at
3.35 TB/s, float32 outside the tensor cores at 67 TFLOP/s.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

# regularize_fused: 25 B a pixel read (idepth, var, vdy, idepth_smoothed,
# var_smoothed, blacklisted 4 each, valid 1) and 13 B written (valid 1,
# blacklisted, idepth_smoothed, var_smoothed 4 each); 25 taps of 12
# operations and a 10-operation epilogue a pixel
REGULARIZE_BYTES_PER_PX = 25 + 13
REGULARIZE_OPS_PER_PX = 25 * 12 + 10


def bound_s(nbytes: float, ops: float) -> float:
    """The least seconds the card could take: the larger of the bytes at
    the HBM peak and the operations at the float32 peak."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOP_PER_S)


def regularize_fused_s(h: int, w: int) -> float:
    n = h * w
    return bound_s(REGULARIZE_BYTES_PER_PX * n, REGULARIZE_OPS_PER_PX * n)


def epl_prepare_s(h: int, w: int, n_frames: int = 1) -> float:
    """The observe sweep's set-up: 25 B a pixel read, 1 B of each good mask
    it reads (at most two), 48 B written; 45 operations a pixel. A launch
    of which the trace does not say the frame count is counted at one
    frame, the fewest bytes any launch moves."""
    n = h * w
    return bound_s(n * (25 + min(n_frames, 2) + 48), 45 * n)


def observe_fuse_s(h: int, w: int, n_frames: int = 1) -> float:
    """The fusion: 53 B a pixel read (+8 B of k_sel with several frames),
    21 B written; 40 operations a pixel."""
    n = h * w
    multi = 8 if n_frames > 1 else 0
    return bound_s(n * (53 + multi + 21), 40 * n)
