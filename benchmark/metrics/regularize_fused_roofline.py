"""The fused regularise stencil's share of its roofline
(csrc/regularize_stencil.cu, kernel `regularize_kernel<true>`): its
launches times the byte bound of one full-size call (harness/roofline.py)
over its device time in the trace."""

from benchmark.harness import roofline


def read(run):
    n, seconds = run.kernel("regularize_kernel<true>")
    if n == 0 or seconds <= 0:
        return None
    return 100.0 * n * roofline.regularize_fused_s(run.height, run.width) \
        / seconds
