"""The observe sweep's fusion's share of its roofline (csrc/epl_stereo.cu,
kernel `observe_fuse_kernel`): its launches times the byte bound of a
one-frame sweep (harness/roofline.py) over its device time in the
trace."""

from benchmark.harness import roofline


def read(run):
    n, seconds = run.kernel("observe_fuse_kernel")
    if n == 0 or seconds <= 0:
        return None
    return 100.0 * n * roofline.observe_fuse_s(run.height, run.width) \
        / seconds
