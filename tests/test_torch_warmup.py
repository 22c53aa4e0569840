"""The port's warm-up (`system/warmup.py`) on the CPU at 160x128.

`warmup` returns the JAX package's keys (read from the JAX function's
source: running the JAX warm-up here would compile every engine program,
which tests/test_program_cache.py already does), finishes keyframes and
warms the relocaliser; and it leaves nothing behind that a later engine
reads: the same engine run (the first 14 frames of the 160x128 loop of
tests/test_torch_slam.py, `short_port_run`) before and after it gives the
same bits.
"""

import ast
import inspect

import numpy as np
import pytest
import torch

from lsd_slam_tpu.system import warmup as jax_warmup

from lsd_slam_tpu_torch.config import LSDConfig
from lsd_slam_tpu_torch.system import warmup
from lsd_slam_tpu_torch.utils import synth

from _torch_slam_scenario import H, W, short_port_run


def jax_warmup_keys():
    """The keys of the dict literal `out` that the JAX warmup returns."""
    tree = ast.parse(inspect.getsource(jax_warmup))
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and [t.id for t in node.targets] == ["out"]:
            return [k.value for k in node.value.keys]
    raise AssertionError("no `out = {...}` in the JAX warmup")


@pytest.fixture(scope="module")
def runs():
    threads = torch.get_num_threads()
    before = short_port_run()
    info = warmup(synth.default_camera(W, H), LSDConfig(width=W, height=H),
                  enable_slam=True, n_switches=2, device="cpu")
    after = short_port_run()
    torch.set_num_threads(threads)
    return before, info, after


def test_warmup_reports_what_jax_reports(runs):
    _, info, _ = runs
    assert list(info) == jax_warmup_keys()
    assert info["keyframes"] >= 2
    assert info["reloc_warmed"] is True
    assert all(info[k] >= 0 for k in ("total_s", "frame_path_s",
                                      "switch_path_s", "bucket_path_s"))


def test_engine_after_warmup_gives_the_same_bits(runs):
    before, _, after = runs
    assert len(before[2]) >= 3 and before[2] == after[2]
    for a, b in zip(before[:2], after[:2]):
        assert np.array_equal(a, b)
