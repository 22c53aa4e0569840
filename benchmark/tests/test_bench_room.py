"""The room scene (`harness/room.py`): the frozen room's geometry and, on
every surface and for every seed, a texture of the same spectrum and
strength."""

import numpy as np
import torch

from benchmark.cameras.pinhole import Pinhole
from benchmark.harness import room, scene

PIN = Pinhole(134.0, 135.0, 79.5, 63.5, 160, 128)


def test_room_has_the_frozen_geometry():
    pose = scene.bench_trajectory(130, seed=3)[40]
    _, want = scene.render_bench(scene.BenchScene(seed=3), PIN, pose, "cpu")
    img, depth = room.render_room(room.RoomScene(seed=3), PIN, pose, "cpu")
    assert torch.equal(depth, want)
    assert img.shape == (128, 160) and float(img.std()) > 10.0


def test_every_surface_gets_the_same_spectrum_for_every_seed():
    """The seed draws only the waves' directions and phases: amplitudes
    and frequency magnitudes agree, and on a 2 m patch of any surface,
    sampled every 5 mm, the share of shaded samples a gray level or more
    from the next is about the same for every surface and seed tried,
    among them the texture of a seed on which the frozen scene lost the
    track."""
    g = np.linspace(-1.0, 1.0, 400)
    uu, vv = np.meshgrid(g, g)
    first = room.RoomScene(seed=0)
    shares = []
    for seed in (0, 1, 17, 3137445918, 2**32 - 1):
        r = room.RoomScene(seed=seed)
        assert torch.equal(r.amps2, first.amps2)
        assert torch.allclose(torch.linalg.vector_norm(r.freq2, dim=-1),
                              torch.linalg.vector_norm(first.freq2, dim=-1))
        if seed:
            assert not torch.equal(r.freq2, first.freq2)
        for s in range(len(r.basis)):
            b = r.basis[s].double().numpy()
            pts = uu[..., None] * b[0] + vv[..., None] * b[1]
            img = r.shade(r.texture(torch.as_tensor(pts, dtype=torch.float32),
                                    torch.full(uu.shape, s))).numpy()
            grad = np.hypot(np.diff(img, axis=0)[:, :-1],
                            np.diff(img, axis=1)[:-1])
            shares.append(float((grad >= 1.0).mean()))
    assert all(0.6 < x < 0.9 for x in shares), shares
