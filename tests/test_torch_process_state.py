"""Process state that does not move the port's CPU bits.

A long-lived pytest-xdist worker was once seen to run the port's 160x128
SLAM scenario to other bits than a fresh process (ROADMAP Queue 3). These
are the suspects cleared so far, each held to bit-equality in one
process: the torch intra-op thread count changed and restored, the
flush-to-zero / denormals-are-zero mode, and a JAX program run in the same
process. The first 14 frames of that scenario (keyframe switches,
propagate, the constraint search, PGO; `short_port_run`) are run again
after each.
"""

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
