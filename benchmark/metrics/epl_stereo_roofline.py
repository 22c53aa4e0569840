"""The EPL search's share of its roofline (csrc/epl_stereo.cu, kernel
`epl_stereo_kernel`, one launch an observe sweep): the least time the
card could take for the window's launches over their device time in the
trace. The searched points are the program's counter `observe_processed`
(the fused count of pixels a sweep processed, which equals the searched
slots `valid_k` of every sweep: tests/test_torch_epl_host.py), summed
over every sweep.

The bound is the search's part of `chip_smoke.py`'s `epl_bounds` (lines
2403-2427 at commit e1b14f9, with `EPL_OPS_PER_SLOT` of line 470): of a
searched slot flat_idx 8 B, the set-up and gradients 28 B, 16 B of
results; the keyframe's and one reference image, 4 B a pixel each, once
a launch; EPL_OPS_PER_SLOT operations a searched slot. The byte of
valid_k a slot of the budget is left out (the budget is not counted),
and every launch is taken as one frame's, the fewest bytes one moves, so
the bound never counts too much. Bytes and operations are summed over the
window and the larger of the two bounds taken, which never exceeds the
sum of the launches' own bounds."""

from benchmark.harness import roofline

EPL_OPS_PER_SLOT = 43 * 24 + 2 * 34 * 5 * 3 + 90 + 60 + 50


def search_bytes(searched: float, pixels: int, launches: int,
                 frames: int = 1, slots: float = 0) -> float:
    multi = 8 if frames > 1 else 0    # k_sel, read with several frames
    return (slots * 1 + searched * (8 + 28 + multi + 16)
            + launches * pixels * 4 * (1 + frames))


def search_ops(searched: float) -> float:
    return EPL_OPS_PER_SLOT * searched


def read(run):
    n, seconds = run.kernel("epl_stereo_kernel")
    searched = run.counter("observe_processed")
    if n == 0 or seconds <= 0 or searched <= 0:
        return None
    bound = roofline.bound_s(
        search_bytes(searched, run.width * run.height, n),
        search_ops(searched))
    return 100.0 * bound / seconds
