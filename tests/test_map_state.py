import jax.numpy as jnp
import numpy as np

from ms_slam.models import map_state as M

CFG = M.MapConfig(max_kf=8, max_mp=64, n_feat=16)


def small_map(rng):
    ms = M.empty_map(CFG)
    # 3 keyframes, overlapping observations
    for k in range(3):
        obs = np.full(16, -1, np.int32)
        # kf0 sees mp 0..9, kf1 sees 5..14, kf2 sees 10..19
        for i in range(10):
            obs[i] = k * 5 + i
        ms = M.insert_keyframe(
            ms, jnp.asarray(k),
            jnp.eye(3), jnp.zeros(3) + k,
            jnp.asarray(rng.uniform(0, 100, (16, 2)).astype(np.float32)),
            jnp.zeros(16, jnp.int32),
            jnp.asarray(rng.integers(0, 2**32, (16, 8), dtype=np.uint32)),
            jnp.full(16, -1.0), jnp.full(16, -1.0),
            jnp.asarray(obs >= 0), jnp.asarray(obs), jnp.asarray(k))
    slots = jnp.arange(20)
    ms = M.add_map_points(
        ms, slots, jnp.ones(20, bool),
        jnp.asarray(rng.normal(size=(20, 3)).astype(np.float32)),
        jnp.asarray(rng.integers(0, 2**32, (20, 8), dtype=np.uint32)),
        jnp.zeros((20, 3)), jnp.zeros(20), jnp.full(20, 100.0),
        jnp.zeros(20, jnp.int32))
    return ms


class TestMapState:
    def test_obs_count(self, rng):
        ms = small_map(rng)
        cnt = np.asarray(M.mp_obs_count(ms))
        # mp 5..9 seen by kf0,kf1; mp 10..14 by kf1,kf2
        assert (cnt[5:15] == 2).all()
        assert (cnt[0:5] == 1).all() and (cnt[15:20] == 1).all()
        assert (cnt[20:] == 0).all()

    def test_covisibility(self, rng):
        ms = small_map(rng)
        c0 = np.asarray(M.covisibility_counts(ms, jnp.asarray(0)))
        assert c0[1] == 5 and c0[2] == 0 and c0[0] == 0
        idx, w, ok = M.best_covisible(ms, jnp.asarray(1), 3, min_weight=1)
        top = set(np.asarray(idx)[np.asarray(ok)].tolist())
        assert top == {0, 2}

    def test_local_map_mask(self, rng):
        ms = small_map(rng)
        mask = M.local_map_mask(ms, jnp.asarray([0, 1]), jnp.ones(2, bool))
        m = np.asarray(mask)
        assert m[:15].all() and not m[15:].any()
        idx, valid = M.gather_local_points(ms, mask, 32)
        assert set(np.asarray(idx)[np.asarray(valid)].tolist()) == set(range(15))

    def test_delete_map_points(self, rng):
        ms = small_map(rng)
        kill = jnp.zeros(64, bool).at[7].set(True)
        ms2 = M.delete_map_points(ms, kill)
        assert not bool(ms2.mp_valid[7])
        assert (np.asarray(ms2.obs_mp) != 7).all()
        # other observations intact
        assert np.asarray(M.mp_obs_count(ms2))[6] == 2

    def test_delete_keyframe(self, rng):
        ms = small_map(rng)
        kill = jnp.zeros(8, bool).at[1].set(True)
        ms2 = M.delete_keyframes(ms, kill)
        cnt = np.asarray(M.mp_obs_count(ms2))
        assert (cnt[5:15] == 1).all()

    def test_majority_descriptor(self, rng):
        ms = small_map(rng)
        # give both observations of mp 5 the same descriptor; majority should
        # then equal it exactly
        d = jnp.asarray(rng.integers(0, 2**32, (8,), dtype=np.uint32))
        ms = ms._replace(kp_desc=ms.kp_desc.at[0, 5].set(d).at[1, 0].set(d))
        ms2 = M.recompute_mp_descriptors(ms, jnp.arange(64))
        np.testing.assert_array_equal(np.asarray(ms2.mp_desc[5]), np.asarray(d))
