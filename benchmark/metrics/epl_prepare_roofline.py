"""The observe sweep's per-pixel set-up's share of its roofline
(csrc/epl_stereo.cu, kernel `epl_prepare_kernel`): its launches times the
byte bound of a one-frame sweep (harness/roofline.py; a launch over
several frames moves more, so this never counts too many bytes) over its
device time in the trace."""

from benchmark.harness import roofline


def read(run):
    n, seconds = run.kernel("epl_prepare_kernel")
    if n == 0 or seconds <= 0:
        return None
    return 100.0 * n * roofline.epl_prepare_s(run.height, run.width) \
        / seconds
