import jax.numpy as jnp
import numpy as np

from ms_slam.ops import hamming, orb

CFG = orb.OrbConfig(n_features=512, n_levels=4)


def checkerboard(h=240, w=320, cell=24, rng=None):
    """Synthetic corner-rich image."""
    img = np.zeros((h, w), np.float32)
    ys, xs = np.mgrid[0:h, 0:w]
    img = (((ys // cell) + (xs // cell)) % 2).astype(np.float32) * 200.0 + 20.0
    if rng is not None:
        img += rng.normal(0, 2.0, size=img.shape).astype(np.float32)
    return jnp.asarray(img)


def mondrian(rng, h=240, w=320, n_rects=120):
    """Random overlapping rectangles: corner-rich AND locally distinctive
    (checkerboards are self-similar, so descriptors there are ambiguous)."""
    img = np.full((h, w), 128.0, np.float32)
    for _ in range(n_rects):
        y0, x0 = rng.integers(0, h - 10), rng.integers(0, w - 10)
        rh, rw = rng.integers(8, h // 3), rng.integers(8, w // 3)
        img[y0:y0 + rh, x0:x0 + rw] = rng.uniform(10, 245)
    return img


class TestBits:
    def test_pack_unpack_roundtrip(self, rng):
        bits = jnp.asarray(rng.integers(0, 2, size=(32, 256)).astype(bool))
        packed = orb.pack_bits(bits)
        assert packed.shape == (32, 8) and packed.dtype == jnp.uint32
        np.testing.assert_array_equal(orb.unpack_bits(packed), bits)

    def test_hamming_matmul_equals_popcount(self, rng):
        a = jnp.asarray(rng.integers(0, 2**32, size=(64, 8), dtype=np.uint32))
        b = jnp.asarray(rng.integers(0, 2**32, size=(48, 8), dtype=np.uint32))
        hm = hamming.hamming_matrix(a, b)
        for i in [0, 13, 63]:
            for j in [0, 21, 47]:
                hp = hamming.hamming_pop(a[i], b[j])
                assert int(hm[i, j]) == int(hp)

    def test_hamming_self_zero(self, rng):
        a = jnp.asarray(rng.integers(0, 2**32, size=(16, 8), dtype=np.uint32))
        hm = hamming.hamming_matrix(a, a)
        np.testing.assert_array_equal(np.diag(np.asarray(hm)), 0)


class TestExtract:
    def test_finds_corners(self, rng):
        img = checkerboard(rng=rng)
        f = orb.extract(img, CFG)
        assert f.xy.shape == (512, 2)
        n_valid = int(jnp.sum(f.valid))
        assert n_valid > 100, n_valid
        # all valid keypoints inside bounds
        xy = np.asarray(f.xy)[np.asarray(f.valid)]
        assert (xy[:, 0] >= 0).all() and (xy[:, 0] < 320).all()
        assert (xy[:, 1] >= 0).all() and (xy[:, 1] < 240).all()

    def test_deterministic(self, rng):
        img = checkerboard(rng=rng)
        f1 = orb.extract(img, CFG)
        f2 = orb.extract(img, CFG)
        np.testing.assert_array_equal(f1.desc, f2.desc)
        np.testing.assert_array_equal(f1.xy, f2.xy)

    def test_translation_equivariance(self, rng):
        """Shifting the image shifts level-0 keypoints (coarse check)."""
        img = np.asarray(checkerboard(rng=rng))
        shift = 8
        img2 = np.roll(img, shift, axis=1)
        f1 = orb.extract(jnp.asarray(img), CFG)
        f2 = orb.extract(jnp.asarray(img2), CFG)
        v1 = np.asarray(f1.valid) & (np.asarray(f1.octave) == 0)
        v2 = np.asarray(f2.valid) & (np.asarray(f2.octave) == 0)
        s1 = set(map(tuple, np.asarray(f1.xy)[v1].astype(int) + [shift, 0]))
        s2 = set(map(tuple, np.asarray(f2.xy)[v2].astype(int)))
        # most shifted kps re-detected away from borders
        common = len(s1 & s2)
        assert common > 0.6 * min(len(s1), len(s2)), (common, len(s1), len(s2))

    def test_descriptor_match_quality(self, rng):
        """Matching features between a frame and its noisy copy should link
        mostly identical locations."""
        img = mondrian(rng)
        img2 = img + rng.normal(0, 4.0, img.shape).astype(np.float32)
        f1 = orb.extract(jnp.asarray(img), CFG)
        f2 = orb.extract(jnp.asarray(img2), CFG)
        d = hamming.hamming_matrix(f1.desc, f2.desc)
        d = jnp.where(f1.valid[:, None] & f2.valid[None, :], d, 10000)
        best = jnp.argmin(d, axis=1)
        bd = jnp.take_along_axis(d, best[:, None], 1)[:, 0]
        ok = np.asarray(f1.valid) & (np.asarray(bd) < 60)
        err = np.linalg.norm(
            np.asarray(f1.xy)[ok] - np.asarray(f2.xy)[np.asarray(best)[ok]], axis=1)
        assert ok.sum() > 50
        assert np.median(err) < 2.0, np.median(err)


def test_fast_score_on_flat_is_zero():
    img = jnp.full((64, 64), 100.0)
    s = orb.fast_score(img, 7.0)
    np.testing.assert_array_equal(np.asarray(s), 0.0)

