import os
import tempfile

import numpy as np

from ms_slam.utils.viewer import MapSnapshot


class _FakeSlam:
    def __init__(self, rng):
        import jax.numpy as jnp
        from ms_slam.models import map_state as M
        cfg = M.MapConfig(max_kf=8, max_mp=64, n_feat=16)
        ms = M.empty_map(cfg)
        ms = ms._replace(
            mp_pos=jnp.asarray(rng.normal(size=(64, 3)).astype(np.float32)),
            mp_valid=jnp.asarray(rng.random(64) > 0.3),
            mp_sparsified=jnp.asarray(rng.random(64) > 0.5),
            kf_valid=jnp.asarray(np.arange(8) < 5),
            kf_sparsified=jnp.asarray(np.arange(8) < 2))
        self.ms = ms

    def poses_wc(self):
        out = []
        for i in range(10):
            T = np.eye(4)
            T[:3, 3] = [0.1 * i, 0, 0.05 * i]
            out.append((0.1 * i, T))
        return out


def test_snapshot_ply_and_plot(rng):
    snap = MapSnapshot.from_system(_FakeSlam(rng))
    with tempfile.TemporaryDirectory() as d:
        ply = os.path.join(d, "map.ply")
        png = os.path.join(d, "map.png")
        snap.save_ply(ply)
        snap.plot_topdown(png)
        assert os.path.getsize(ply) > 100
        assert os.path.getsize(png) > 1000
        head = open(ply).read(200)
        assert "element vertex" in head


def test_frame_drawer(tmp_path, rng):
    """FrameDrawer analog: overlay PNG is written with the right size."""
    from ms_slam.utils.viewer import draw_frame
    img = rng.integers(0, 255, (120, 160), dtype=np.uint8)
    n = 64
    xy = rng.uniform(0, [160, 120], (n, 2)).astype(np.float32)
    valid = rng.random(n) < 0.8
    tracked = rng.random(n) < 0.5
    out = tmp_path / "frame.png"
    draw_frame(img, xy, valid, tracked, str(out), state="OK")
    assert out.exists() and out.stat().st_size > 500
