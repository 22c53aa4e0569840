"""Process state that does not move the port's CPU bits.

The port's 160x128 SLAM scenario was seen to run to other bits in some
processes than in others under load (ROADMAP Queue 3). The cause: MKL's
vector math (torch.sqrt, exp, ... on CPU float tensors) sets up its code
path in its first call in a process, and when ATen splits that call over
OpenMP threads, threads that enter during the set-up compute their share
to other last bits. The port makes one small call on the importing thread
first (`lsd_slam_tpu_torch/__init__.py`); `test_first_vector_math_call_*`
holds fresh processes to that. The other suspects, cleared and held here
to bit-equality in one process: the torch intra-op thread count changed
and restored, the flush-to-zero / denormals-are-zero mode, and a JAX
program run in the same process. The first 14 frames of that scenario
(keyframe switches, propagate, the constraint search, PGO;
`short_port_run`) are run again after each.
"""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_slam_scenario import short_port_run


def _thread_counts():
    torch.set_num_threads(4)
    torch.ones(512, 512).sum()
    torch.set_num_threads(1)
    torch.ones(512, 512).sum()


def _jax_program():
    x = jnp.asarray(np.random.default_rng(0).standard_normal((256, 256)),
                    jnp.float32)
    jax.block_until_ready(jax.jit(lambda a: (a @ a.T).sum())(x))


@pytest.fixture(scope="module")
def baseline():
    before = torch.get_num_threads()
    run = short_port_run()
    assert len(run[2]) >= 3, run[2]
    yield run
    torch.set_num_threads(before)


@pytest.mark.parametrize("disturb", ["repeat", "thread_counts",
                                     "flush_denormal", "jax_program"])
def test_process_state_keeps_the_port_bits(baseline, disturb):
    flush = disturb == "flush_denormal"
    if disturb == "thread_counts":
        _thread_counts()
    elif disturb == "jax_program":
        _jax_program()
    elif flush and not torch.set_flush_denormal(True):
        pytest.skip("this CPU has no flush-to-zero mode")
    try:
        got = short_port_run()
    finally:
        if flush:
            torch.set_flush_denormal(False)
    for a, b in zip(got, baseline):
        assert np.array_equal(a, b)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# a fresh process: import the port, then the first sqrt, exp and sin of
# 2e6 floats (ATen splits each over the 8 OpenMP threads), then all again
_FIRST_CALL = """
import zlib
import torch
import lsd_slam_tpu_torch  # noqa: F401
torch.set_num_threads(8)
x = torch.rand(2000000, generator=torch.Generator().manual_seed(0)) * 3


def crcs():
    return [zlib.crc32(f(x + 0.1).numpy().tobytes())
            for f in (torch.sqrt, torch.exp, torch.sin)]


print(crcs(), crcs())
"""


def test_first_vector_math_call_keeps_its_bits():
    """MKL's vector math in fresh processes that imported the port: the
    first sqrt, exp and sin, each split over 8 idle OpenMP threads (the
    condition: with every core free the threads enter the call together),
    give the bits of the calls after them, in each of 12 processes run one
    after another, and every process gives the same bits. Without the
    port's set-up call, 5-10% of such first calls took other bits (ROADMAP
    Queue 3), so 36 of them catch it all but rarely."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    runs = []
    for _ in range(12):
        proc = subprocess.run([sys.executable, "-c", _FIRST_CALL], cwd=ROOT,
                              env=env, capture_output=True, text=True,
                              timeout=120)
        assert proc.returncode == 0, proc.stderr[-2000:]
        runs.append(proc.stdout.strip())
    for run in runs:
        first, later = run.split("] [")
        assert first + "]" == "[" + later, run
    assert len(set(runs)) == 1, runs
