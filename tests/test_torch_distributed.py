"""The port's mesh programs (`lsd_slam_tpu_torch/parallel/distributed.py`)
against the JAX package's on the CPU: the port at `make_mesh(8, "cpu")`
(eight shards of the CPU), JAX at `make_mesh(8)` (conftest's eight virtual
CPU devices), on the inputs of tests/test_distributed.py.

Bounds:
  * assembly: H within rtol 1e-4 / atol 1e-3, g within rtol 1e-4 / atol
    1e-4 and the chi2 sum within rtol 1e-4 of JAX's (the JAX test's own);
    the port's mesh assembly equals its one-device `_assemble` bit for bit
    (the blocks are gathered in edge order and assembled by the same
    ordered adds);
  * dense step: six steps halve chi2 (the JAX test's bound), and the first
    step's poses lie within 1e-5 of JAX's step (both f32 solves of the same
    7N x 7N system);
  * CG step: chi2 within rtol 1e-5 and poses within 5e-4 of the dense step
    (the JAX test's bounds); poses within 1e-5 of JAX's CG step (both f32
    PCG at tol 1e-7, psums summed in other orders); a one-shard mesh gives
    `pcg_solve`'s bits;
  * sharded quick track (both directions): good flags equal and
    ref_to_frame within 1e-5 of JAX's sharded track and of the port's
    unsharded batch;
  * `pad_to_mesh` equals JAX's for n in 0..70 at mesh sizes 1, 2, 4, 8.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lsd_slam_tpu import parallel as jpar
from lsd_slam_tpu.camera import Camera as JaxCamera
from lsd_slam_tpu.lie import np_sim3 as nps
from lsd_slam_tpu.ops.interp import quad_pack
from lsd_slam_tpu.tracking.quick_tracker import QuickTracker as JaxQuick
from lsd_slam_tpu.tracking.reference import PointSet as JaxPointSet
from lsd_slam_tpu.tracking.reference import compact_points

from lsd_slam_tpu_torch import interop
from lsd_slam_tpu_torch.camera import Camera
from lsd_slam_tpu_torch.mapping import sparse_pgo as tsp
from lsd_slam_tpu_torch.mapping.pose_graph import _assemble
from lsd_slam_tpu_torch.parallel import (
    default_mesh, distributed_pgo_cg_step, distributed_pgo_normal_equations,
    distributed_pgo_step, make_mesh, pad_to_mesh, sharded_quick_track,
    sharded_quick_track_frames)
from lsd_slam_tpu_torch.tracking import quick_tracker as tqt

from tests._torch_parity import to_dict
from tests.test_distributed import _random_graph


def _torch_graph(graph):
    poses, efrom, eto, meas_inv, info, deltas = graph
    return (torch.as_tensor(poses), torch.as_tensor(efrom, dtype=torch.int64),
            torch.as_tensor(eto, dtype=torch.int64),
            torch.as_tensor(meas_inv), torch.as_tensor(info),
            torch.as_tensor(deltas))


def _fixed(n):
    fixed = np.zeros(n, bool)
    fixed[0] = True
    return fixed


def test_meshes_on_the_cpu():
    """No default mesh on the CPU (nor on one card): the single-device
    paths run. A CPU mesh repeats the CPU."""
    assert default_mesh("cpu") is None
    mesh = make_mesh(8, "cpu")
    assert mesh.size == 8 and mesh.world == 1
    assert all(d == torch.device("cpu") for d in mesh.devices)


@pytest.mark.parametrize("size", [1, 2, 4, 8])
def test_pad_to_mesh_matches_jax(size):
    jmesh, tmesh = jpar.make_mesh(size), make_mesh(size, "cpu")
    for n in range(71):
        assert pad_to_mesh(n, tmesh) == jpar.pad_to_mesh(n, jmesh), n
        assert pad_to_mesh(n, None) == jpar.pad_to_mesh(n, None), n


def test_assembly_matches_jax_and_one_device():
    n_v, n_e = 10, 24
    graph = _random_graph(np.random.default_rng(0), n_v, n_e)
    jH, jg, jchi = jpar.distributed_pgo_normal_equations(
        jpar.make_mesh(8), n_v)(*(jnp.asarray(a) for a in graph))
    args = _torch_graph(graph)
    H, g, chi = distributed_pgo_normal_equations(make_mesh(8, "cpu"),
                                                 n_v)(*args)
    np.testing.assert_allclose(H.numpy(), np.asarray(jH), rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(float(chi), float(jchi), rtol=1e-4)
    H1, g1, chi1 = _assemble(*args, n_v)
    assert torch.equal(H, H1) and torch.equal(g, g1)
    assert torch.equal(chi, torch.sum(chi1))


def test_dense_step_halves_chi2_and_matches_jax():
    n_v, n_e = 8, 16
    graph = _random_graph(np.random.default_rng(1), n_v, n_e)
    fixed = _fixed(n_v)
    step = distributed_pgo_step(make_mesh(8, "cpu"), n_v)
    poses, *edges = _torch_graph(graph)
    fixed_t = torch.as_tensor(fixed)
    p = poses
    chis = []
    for _ in range(6):
        p, chi, _ = step(p, fixed_t, *edges, 1e-6)
        chis.append(float(chi))
    assert chis[-1] < 0.5 * chis[0], chis

    jstep = jpar.distributed_pgo_step(jpar.make_mesh(8), n_v)
    jp, jchi, _ = jstep(jnp.asarray(graph[0]), jnp.asarray(fixed),
                        *(jnp.asarray(a) for a in graph[1:]),
                        jnp.float32(1e-6))
    p1, chi1, _ = step(poses, fixed_t, *edges, 1e-6)
    np.testing.assert_allclose(p1.numpy(), np.asarray(jp), atol=1e-5)
    np.testing.assert_allclose(float(chi1), float(jchi), rtol=1e-5)


def test_cg_step_matches_dense_step_and_jax():
    n_v, n_e = 12, 32
    graph = _random_graph(np.random.default_rng(4), n_v, n_e)
    fixed = _fixed(n_v)
    mesh = make_mesh(8, "cpu")
    poses, *edges = _torch_graph(graph)
    fixed_t = torch.as_tensor(fixed)
    p_d, chi_d, _ = distributed_pgo_step(mesh, n_v)(poses, fixed_t, *edges,
                                                    1e-6)
    cg = distributed_pgo_cg_step(mesh, n_v, max_cg_iters=400)
    p_c, chi_c, _ = cg(poses, fixed_t, *edges, 1e-6)
    np.testing.assert_allclose(float(chi_d), float(chi_c), rtol=1e-5)
    np.testing.assert_allclose(p_d.numpy(), p_c.numpy(), atol=5e-4)

    jcg = jpar.distributed_pgo_cg_step(jpar.make_mesh(8), n_v,
                                       max_cg_iters=400)
    jp, jchi, _ = jcg(jnp.asarray(graph[0]), jnp.asarray(fixed),
                      *(jnp.asarray(a) for a in graph[1:]),
                      jnp.float32(1e-6))
    np.testing.assert_allclose(p_c.numpy(), np.asarray(jp), atol=1e-5)
    np.testing.assert_allclose(float(chi_c), float(jchi), rtol=1e-5)

    # iterated, chi2 falls
    p = poses
    chis = []
    for _ in range(6):
        p, chi, _ = cg(p, fixed_t, *edges, 1e-6)
        chis.append(float(chi))
    assert chis[-1] < 0.5 * chis[0], chis


def test_one_shard_cg_step_keeps_pcg_solve_bits():
    n_v, n_e = 12, 32
    poses, *edges = _torch_graph(
        _random_graph(np.random.default_rng(4), n_v, n_e))
    fixed = torch.as_tensor(_fixed(n_v))
    delta, chi2, _, _ = tsp.pcg_solve(poses, fixed, *edges, 1e-6, n_v, 250)
    p, chi, dmax = distributed_pgo_cg_step(make_mesh(1, "cpu"), n_v)(
        poses, fixed, *edges, 1e-6)
    assert torch.equal(p, tsp.apply_update(poses, delta))
    assert torch.equal(chi, chi2)
    assert float(dmax) == float(torch.max(torch.abs(delta)))


@pytest.fixture(scope="module")
def quick_batch():
    """tests/test_distributed.py's 8 random keyframe point sets and frame,
    as JAX and port values."""
    rng = np.random.default_rng(2)
    width, height = 64, 48
    jcam = JaxCamera(fx=0.7 * width, fy=0.7 * width, cx=(width - 1) / 2,
                     cy=(height - 1) / 2, width=width, height=height)
    jqt = JaxQuick(jcam)
    lvl = jqt.level
    h4, w4 = height >> lvl, width >> lvl
    n_kf = 8
    imgs = rng.uniform(0, 255, (n_kf, h4, w4)).astype(np.float32)
    idepth = np.full((n_kf, h4, w4), 0.5, np.float32)
    ivar = np.full((n_kf, h4, w4), 0.01, np.float32)
    frame_quad = quad_pack((jnp.asarray(imgs[0]),
                            jnp.zeros((h4, w4), jnp.float32),
                            jnp.zeros((h4, w4), jnp.float32)))
    inits = np.tile(np.array([1, 0, 0, 0, 0, 0, 0], np.float32), (n_kf, 1))

    def pointset(k):
        zeros = np.zeros_like(imgs[k])
        fields = jnp.asarray(np.stack(
            [imgs[k], zeros, zeros, idepth[k], ivar[k]], axis=-1
        ).reshape(-1, 5))
        idx, vals, slot_valid, n_valid = compact_points(
            jnp.ones((h4, w4), bool), fields, h4 * w4)
        return JaxPointSet(idx=idx, ival=vals[:, 0], gx=vals[:, 1],
                           gy=vals[:, 2], idp=vals[:, 3], ivr=vals[:, 4],
                           valid=slot_valid, n_valid=n_valid)

    jrefs = jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs), *[pointset(k) for k in range(n_kf)])
    cam = Camera(fx=jcam.fx, fy=jcam.fy, cx=jcam.cx, cy=jcam.cy,
                 width=width, height=height)
    tq = tqt.QuickTracker(cam)
    assert tq.level == lvl
    return dict(jqt=jqt, jrefs=jrefs, jquad=frame_quad, inits=inits,
                tqt=tq, refs=interop.point_set_from_dict(to_dict(jrefs),
                                                         device="cpu"),
                quad=torch.as_tensor(np.asarray(frame_quad)),
                quads=torch.as_tensor(np.asarray(jnp.stack(
                    [quad_pack((jnp.asarray(im),
                                jnp.zeros((h4, w4), jnp.float32),
                                jnp.zeros((h4, w4), jnp.float32)))
                     for im in imgs]))))


def test_sharded_quick_track_matches_jax_and_batch(quick_batch):
    q = quick_batch
    jout = jpar.sharded_quick_track(jpar.make_mesh(8), q["jqt"])(
        q["jrefs"], q["jquad"], jnp.asarray(q["inits"]))
    inits = torch.as_tensor(q["inits"])
    got = sharded_quick_track(make_mesh(8, "cpu"), q["tqt"])(
        q["refs"], q["quad"], inits)
    batch = q["tqt"].track_batch_pts(q["refs"], q["quad"], inits)
    for want_pose, want_good in ((np.asarray(jout[0]), np.asarray(jout[1])),
                                 (batch.ref_to_frame.numpy(),
                                  batch.tracking_good.numpy())):
        np.testing.assert_array_equal(got.tracking_good.numpy(), want_good)
        np.testing.assert_allclose(got.ref_to_frame.numpy(), want_pose,
                                   atol=1e-5)
    # each shard's LM loop pulls its own flags
    assert got.n_syncs >= 8


def test_sharded_quick_track_frames_matches_jax_and_batch(quick_batch):
    q = quick_batch
    one = jax.tree_util.tree_map(lambda x: x[0], q["jrefs"])
    jout = jpar.sharded_quick_track_frames(jpar.make_mesh(8), q["jqt"])(
        one, jnp.asarray(q["quads"].numpy()), jnp.asarray(q["inits"]))
    ref = interop.point_set_from_dict(to_dict(one), device="cpu")
    inits = torch.as_tensor(q["inits"])
    got = sharded_quick_track_frames(make_mesh(8, "cpu"), q["tqt"])(
        ref, q["quads"], inits)
    batch = q["tqt"].track_batch_frames(ref, q["quads"], inits)
    for want_pose, want_good in ((np.asarray(jout[0]), np.asarray(jout[1])),
                                 (batch.ref_to_frame.numpy(),
                                  batch.tracking_good.numpy())):
        np.testing.assert_array_equal(got.tracking_good.numpy(), want_good)
        np.testing.assert_allclose(got.ref_to_frame.numpy(), want_pose,
                                   atol=1e-5)
