"""The port's appearance index (`mapping/appearance.py`) against the JAX
package's on the CPU, on the cases of tests/test_appearance.py.

Bounds:
  * descriptors (one roll and all N_ROTATIONS rolls) and the max-over-
    rolls scores: within 1e-5 absolute of JAX's on the same level-2 planes
    of a 160x128 frame (unit vectors; XLA and torch round the trig, the
    bilinear weights and the norms differently in the last bits);
  * retrieval: the same keyframe id (or the same None) as JAX's index on
    every case; the integration case surfaces the appearance hit through
    `KeyFrameGraph.find_candidates` when Euclidean search finds nothing.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lsd_slam_tpu import lie as jlie
from lsd_slam_tpu.frames import build_frame as jax_build_frame
from lsd_slam_tpu.mapping import appearance as japp
from lsd_slam_tpu.utils import synth as jsynth

from lsd_slam_tpu_torch.config import LSDConfig, SystemConfig
from lsd_slam_tpu_torch.frames import build_frame
from lsd_slam_tpu_torch.mapping import appearance as tapp
from lsd_slam_tpu_torch.system import Keyframe, PoseNode, SlamSystem
from lsd_slam_tpu_torch.utils import synth

W, H = 160, 128
DESC_ATOL = 1e-5
PLACES = [0.0, 0.35, 0.7, 1.05, 1.4, 1.75]


@pytest.fixture(scope="module")
def world():
    """pyr_at(x, roll, z) -> (JAX pyramid, port pyramid, image, depth) of
    PlaneScene(seed=3) seen from x along the track, rolled and moved
    forward (tests/test_appearance.py's world)."""
    cam = jsynth.default_camera(W, H)
    scene = jsynth.PlaneScene(seed=3)
    cache = {}

    def pyr_at(x, roll=0.0, z=0.0):
        key = (x, roll, z)
        if key not in cache:
            c2w = np.asarray(jlie.se3_mul(
                jlie.se3_exp(jnp.asarray([x, 0, z, 0, 0, 0], jnp.float32)),
                jlie.se3_exp(jnp.asarray([0, 0, 0, 0, 0, roll],
                                         jnp.float32))))
            w2c = np.asarray(jlie.se3_inverse(jnp.asarray(c2w, jnp.float32)))
            img, dep = jsynth.render(scene, cam, jnp.asarray(w2c))
            img = np.array(img)
            cache[key] = (jax_build_frame(jnp.asarray(img), 5),
                          build_frame(torch.as_tensor(img), 5), img,
                          np.asarray(dep))
        return cache[key]

    return pyr_at


def _level2(pyr):
    return [np.asarray(a[2]) for a in (pyr.images, pyr.gx, pyr.gy)]


@pytest.mark.parametrize("roll", [0.0, 0.35, 1.9])
def test_descriptors_and_scores_match_jax(world, roll):
    jpyr = world(0.7, roll=roll, z=0.06)[0]
    planes = _level2(jpyr)
    thetas = np.linspace(0.0, 2 * np.pi, japp.N_ROTATIONS,
                         endpoint=False).astype(np.float32)
    want_one = np.asarray(japp._descriptor_at(*map(jnp.asarray, planes),
                                              jnp.float32(0.0)))
    want_rot = np.asarray(japp._descriptor_rotations(
        *map(jnp.asarray, planes), jnp.asarray(thetas)))
    tp = [torch.as_tensor(a) for a in planes]
    got_one = tapp._descriptor_at(*tp).numpy()
    got_rot = tapp._descriptor_rotations(*tp, torch.as_tensor(thetas)).numpy()
    assert got_rot.shape == want_rot.shape == (japp.N_ROTATIONS,
                                               japp.TILES ** 2
                                               * (japp.ORI_BINS + 1))
    np.testing.assert_allclose(got_one, want_one, rtol=0, atol=DESC_ATOL)
    np.testing.assert_allclose(got_rot, want_rot, rtol=0, atol=DESC_ATOL)
    # scores of the rolled query against the unrolled places
    mat = np.stack([np.asarray(japp._descriptor_at(
        *map(jnp.asarray, _level2(world(x)[0])), jnp.float32(0.0)))
        for x in PLACES])
    want = np.asarray(japp._query_scores(jnp.asarray(mat),
                                         *map(jnp.asarray, planes),
                                         jnp.asarray(thetas)))
    got = tapp._query_scores(torch.as_tensor(mat), *tp,
                             torch.as_tensor(thetas)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=DESC_ATOL)


def _both_indexes(world, places):
    jidx, tidx = japp.AppearanceIndex(), tapp.AppearanceIndex(device="cpu")
    for kf_id, x in places:
        jpyr, tpyr, _, _ = world(x)
        jidx.add(kf_id, jpyr)
        tidx.add(kf_id, tpyr)
    return jidx, tidx


def test_retrieval_invariant_to_roll_and_scale_as_jax(world):
    jidx, tidx = _both_indexes(world, [(k * 100, x)
                                       for k, x in enumerate(PLACES)])
    for k, x in enumerate(PLACES):
        jq, tq, _, _ = world(x, roll=0.35, z=0.06)
        want = jidx.query(jq, query_id=9999)
        assert want == k * 100
        assert tidx.query(tq, query_id=9999) == want


def test_retrieval_rejects_novel_place_as_jax(world):
    jidx, tidx = _both_indexes(world, [(k * 100, x)
                                       for k, x in enumerate(PLACES)])
    jq, tq, _, _ = world(6.0)
    assert jidx.query(jq, query_id=9999) is None
    assert tidx.query(tq, query_id=9999) is None


def test_retrieval_excludes_temporal_neighbors_as_jax(world):
    jidx, tidx = _both_indexes(world, [(0, 0.0), (4, 0.05)])
    jq, tq, _, _ = world(0.0)
    assert jidx.query(jq, query_id=8) is None
    assert tidx.query(tq, query_id=8) is None


def test_index_scales_to_200_keyframes_as_jax():
    """tests/test_appearance.py::test_index_scales_to_200_keyframes: 200
    smoothed random 32x40 images, a noisy revisit of place 30; capacity
    grows from 32 by doubling, both indexes return 300."""
    rng = np.random.default_rng(0)
    h, w = 32, 40
    base = [rng.uniform(0, 255, (h, w)).astype(np.float32)
            for _ in range(200)]

    def smooth(a):
        return (a + np.roll(a, 1, 0) + np.roll(a, 1, 1)
                + np.roll(a, -1, 0) + np.roll(a, -1, 1)) / 5.0
    base = [smooth(smooth(b)) for b in base]

    def fake_pyr(img, conv):
        g = np.gradient(img)
        return type("FakePyr", (), dict(
            images={2: conv(img)}, gx={2: conv(g[1] * 2)},
            gy={2: conv(g[0] * 2)}))

    jidx = japp.AppearanceIndex(level=2)
    tidx = tapp.AppearanceIndex(level=2, device="cpu")
    for k in range(200):
        jidx.add(k * 10, fake_pyr(base[k], jnp.asarray))
        tidx.add(k * 10, fake_pyr(base[k], torch.as_tensor))
    assert len(tidx) == 200 and tidx._capacity == jidx._capacity == 256
    assert tidx._mat.shape == (256, tidx._mat.shape[1])
    np.testing.assert_allclose(tidx._mat.numpy(), np.asarray(jidx._mat),
                               rtol=0, atol=DESC_ATOL)
    q = base[30] + rng.normal(0, 2.0, (h, w)).astype(np.float32)
    want = jidx.query(fake_pyr(q, jnp.asarray), query_id=10_000)
    assert want == 300
    assert tidx.query(fake_pyr(q, torch.as_tensor), query_id=10_000) == want


def test_appearance_path_finds_candidate_when_euclidean_cannot(world):
    """tests/test_appearance.py:68 on the port: find_candidates surfaces
    the appearance hit (and its neighbours) when the query keyframe's pose
    has drifted so far that Euclidean overlap search returns nothing."""
    cfg = LSDConfig(width=W, height=H).replace(
        system=SystemConfig(use_fabmap=True))
    cam = synth.default_camera(W, H)
    sys_ = SlamSystem(cam, cfg, enable_slam=True, device="cpu")
    graph = sys_.backend.graph
    assert isinstance(graph.appearance, tapp.AppearanceIndex)

    for k, x in enumerate(PLACES):
        _, pyr, _, dep = world(x)
        node = PoseNode(k * 100, sys_.registry)
        node.this_to_parent = np.array([1, 0, 0, 0, x, 0, 0, 1.0])
        kf = Keyframe(k * 100, 0.0, pyr, node, 5)
        sys_.map.initialize_from_gt(
            torch.as_tensor(1.0 / np.maximum(dep, 1e-6)), pyr.max_grad[0])
        sys_._export_depth_to(kf)
        kf.idx_in_keyframes = k
        sys_.keyframes.append(kf)
        sys_.id_to_keyframe[kf.id] = kf
        graph.add_keyframe(kf)
    assert len(graph.appearance) == len(PLACES)

    _, pyr, _, _ = world(PLACES[2], roll=0.3)
    node = PoseNode(9999, sys_.registry)
    node.this_to_parent = np.array([1, 0, 0, 0, 100.0, 100.0, 0, 1.0])
    query = Keyframe(9999, 0.0, pyr, node, 5)
    query.mean_idepth = 1.0
    euclid = graph.find_euclidean_overlap_frames(
        node.this_to_parent, 1.0, 15.0 / 16.0, 0.75, True)
    assert euclid == []
    cands, fabmap_id = graph.find_candidates(query, 1.0)
    assert fabmap_id == 200, (fabmap_id, sorted(cands))
    assert 200 in cands
    # use_fabmap=False keeps to the Euclidean set
    assert graph.find_candidates(query, 1.0, use_fabmap=False) == ({}, None)
    # one query scored the index and hit; use_fabmap=False asked nothing
    assert (graph.appearance.n_queries, graph.appearance.n_hits) == (1, 1)
