"""The hole fill's roofline reader on a stand-in run: its bound against
chip_smoke.py's, the calls counted from the final pass alone, every pass's
time, and nothing read from a trace without the kernel."""

import pytest

from benchmark.metrics import fill_holes_roofline as fill


class FakeRun:
    width, height = 640, 480

    def __init__(self, kernels):
        self.kernels = kernels   # name -> (launches, seconds)

    def kernel(self, fragment):
        hits = [v for k, v in self.kernels.items() if fragment in k]
        return (sum(n for n, _ in hits), sum(s for _, s in hits))


ROWS = "_anonymous_namespace_::fill_holes_rows_kernel__anonymous_namespace"
FUSE = "_anonymous_namespace_::fill_holes_fuse_kernel__anonymous_namespace"


def test_bound_is_the_bytes_at_640x480():
    # 50 B a pixel at 3.35 TB/s; the operations take a fifth of that
    assert fill.fill_holes_s(480, 640) == pytest.approx(
        50 * 480 * 640 / 3.35e12)
    assert fill.fill_holes_s(480, 640) * 1e3 == pytest.approx(0.004585,
                                                              abs=1e-6)


def test_share_counts_calls_by_the_final_pass_and_time_over_both():
    bound = fill.fill_holes_s(480, 640)
    run = FakeRun({ROWS: (100, 100 * bound), FUSE: (100, 100 * bound),
                   "void at::native::vectorized_elementwise_kernel": (
                       1000, 1.0)})
    assert fill.read(run) == pytest.approx(50.0)


@pytest.mark.parametrize("kernels", [{}, {"void at::native::fill": (5, 1e-3)},
                                     {ROWS: (3, 1e-5)}])
def test_reads_nothing_without_the_kernel(kernels):
    assert fill.read(FakeRun(kernels)) is None
