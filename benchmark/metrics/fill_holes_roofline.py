"""The hole fill's share of its roofline (csrc/fill_holes.cu, kernels
`fill_holes_rows_kernel` then `fill_holes_fuse_kernel`, one call a
launch of each): the calls (launches of the final pass) times the
shape-only bound of one call over the device time of every pass in the
trace, matched by their shared name fragment. The final pass starts
while the first runs (a programmatic dependent launch); their times are
summed, overlap and all.

The bound counts only the bytes any implementation moves, 29 B a pixel
read (valid 1; validity, idepth, var, blacklisted, max_grad,
idepth_smoothed, var_smoothed 4 each) and 21 B written (valid 1, five f32
planes), against ~195 f32 operations a pixel: 4.59 us at 640x480, bound
by the bytes. The integral image's own traffic between the passes is left
out, so the share can only read low. A program without the kernel (the
plain version's ~400 torch operations) reads nothing."""

from benchmark.harness import roofline

FILL_HOLES_BYTES_PER_PX = 29 + 21
FILL_HOLES_OPS_PER_PX = 195


def fill_holes_s(h: int, w: int) -> float:
    n = h * w
    return roofline.bound_s(FILL_HOLES_BYTES_PER_PX * n,
                            FILL_HOLES_OPS_PER_PX * n)


def read(run):
    calls, _ = run.kernel("fill_holes_fuse_kernel")
    _, seconds = run.kernel("fill_holes_")
    if calls == 0 or seconds <= 0:
        return None
    return 100.0 * calls * fill_holes_s(run.height, run.width) / seconds
