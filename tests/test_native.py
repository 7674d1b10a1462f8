"""Native runtime: decode, remap, prefetch pipeline vs cv2 reference."""
import os
import tempfile

import numpy as np
import pytest

from ms_slam.utils import native

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native runtime not built")


def write_pngs(d, n, h=60, w=80, rng=None):
    import cv2
    paths = []
    for i in range(n):
        img = rng.integers(0, 255, size=(h, w), dtype=np.uint8)
        p = os.path.join(d, f"{i:04d}.png")
        cv2.imwrite(p, img)
        paths.append(p)
    return paths


def test_decode_matches_cv2(rng):
    import cv2
    with tempfile.TemporaryDirectory() as d:
        p = write_pngs(d, 1, rng=rng)[0]
        ref = cv2.imread(p, cv2.IMREAD_GRAYSCALE)
        got = native.decode_gray(p, 80, 60)
        np.testing.assert_array_equal(got, ref)


def test_remap_matches_cv2(rng):
    import cv2
    src = rng.integers(0, 255, size=(40, 50), dtype=np.uint8)
    mx, my = np.meshgrid(np.arange(50, dtype=np.float32),
                         np.arange(40, dtype=np.float32))
    mx = mx + 0.3
    my = my + 0.6
    ref = cv2.remap(src, mx, my, cv2.INTER_LINEAR,
                    borderMode=cv2.BORDER_CONSTANT)
    got = native.remap(src, mx, my)
    # interior pixels must agree within rounding
    diff = np.abs(ref[1:-2, 1:-2].astype(int) - got[1:-2, 1:-2].astype(int))
    assert diff.max() <= 1


def test_pipeline_order_and_content(rng):
    import cv2
    with tempfile.TemporaryDirectory() as d:
        pl = write_pngs(d, 12, rng=rng)
        pr = write_pngs(d + os.sep, 0, rng=rng) if False else pl
        pipe = native.PrefetchPipeline(pl, pr, width=80, height=60,
                                       depth=4, n_workers=3)
        for i, (l, r) in enumerate(pipe):
            ref = cv2.imread(pl[i], cv2.IMREAD_GRAYSCALE)
            np.testing.assert_array_equal(l, ref)
            np.testing.assert_array_equal(r, ref)
        assert i == 11
        pipe.close()


def test_vmrss():
    assert native.vmrss_mb() > 10


def test_dataset_frames_use_prefetch(rng, tmp_path, monkeypatch):
    """Driver path (VERDICT r2 item 4): KittiOdometry.frames() must route
    through the native prefetch pipeline when it is available, and yield
    the same frames as the cv2 fallback."""
    import cv2
    seq = tmp_path / "seq"
    (seq / "image_0").mkdir(parents=True)
    (seq / "image_1").mkdir(parents=True)
    n = 6
    for i in range(n):
        img = rng.integers(0, 255, size=(48, 64), dtype=np.uint8)
        cv2.imwrite(str(seq / "image_0" / f"{i:06d}.png"), img)
        cv2.imwrite(str(seq / "image_1" / f"{i:06d}.png"), img)
    (seq / "times.txt").write_text("\n".join(str(0.1 * i) for i in range(n)))

    from ms_slam.utils import datasets

    used = {"pipes": 0}
    real_pipe = native.PrefetchPipeline

    class SpyPipe(real_pipe):
        def __init__(self, *a, **k):
            used["pipes"] += 1
            super().__init__(*a, **k)

    monkeypatch.setattr(native, "PrefetchPipeline", SpyPipe)
    ds = datasets.KittiOdometry(str(seq))
    got = list(ds.frames(prefetch=True))
    assert used["pipes"] == 1, "native prefetch not used by the driver path"
    ref = list(ds.frames(prefetch=False))
    assert len(got) == len(ref) == n
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.left, b.left)
        np.testing.assert_array_equal(a.right, b.right)
        assert a.timestamp == b.timestamp

    # the lookahead wrapper drivers use to feed next_images
    pairs = list(datasets.with_lookahead(iter(ref)))
    assert pairs[-1][1] is None
    np.testing.assert_array_equal(pairs[0][1][0], ref[1].left)


def test_pipeline_stress_in_order(rng):
    """Workers outnumber ring slots, so frames that map to one slot race
    for it; the in-order consumer must never stall. Each run is bounded by
    a join timeout."""
    import threading
    with tempfile.TemporaryDirectory() as d:
        paths = write_pngs(d, 24, h=12, w=16, rng=rng)
        for depth, workers in [(2, 6), (3, 8), (4, 3)]:
            for _ in range(10):
                got = []
                pipe = native.PrefetchPipeline(paths, paths, width=16,
                                               height=12, depth=depth,
                                               n_workers=workers)
                t = threading.Thread(
                    target=lambda: got.extend(l for l, _ in pipe),
                    daemon=True)
                t.start()
                t.join(timeout=30)
                assert not t.is_alive(), (depth, workers, len(got))
                pipe.close()
                assert len(got) == 24
