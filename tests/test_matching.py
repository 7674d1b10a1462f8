"""Direct unit tests for projection-guided matching."""
import jax.numpy as jnp
import numpy as np

from ms_slam.ops import cameras, lie, matching

PIN = cameras.pad_params([300.0, 300.0, 160.0, 120.0])


def make_scene(rng, n_pts=64, n_feat=128):
    X = rng.uniform(-3, 3, (n_pts, 3))
    X[:, 2] += 8.0
    R, t = lie.se3_exp(jnp.asarray([0.05, 0.02, -0.03, 0.01, 0.02, 0.0]))
    Xc = np.asarray(lie.se3_apply(R, t, jnp.asarray(X)))
    uv = np.array(cameras.pinhole_project(PIN, jnp.asarray(Xc)))
    descs = rng.integers(0, 2 ** 32, (n_pts, 8), dtype=np.uint32)
    # frame features: the projections (slightly perturbed) + distractors
    f_xy = np.zeros((n_feat, 2), np.float32)
    f_desc = np.zeros((n_feat, 8), np.uint32)
    f_xy[:n_pts] = uv + rng.normal(0, 0.5, uv.shape)
    f_desc[:n_pts] = descs  # identical descriptors -> distance 0
    f_xy[n_pts:] = rng.uniform(0, 300, (n_feat - n_pts, 2))
    f_desc[n_pts:] = rng.integers(0, 2 ** 32, (n_feat - n_pts, 8),
                                  dtype=np.uint32)
    return X, descs, R, t, f_xy, f_desc, n_pts


def test_projection_matching_recovers_correspondences(rng):
    X, descs, R, t, f_xy, f_desc, n_pts = make_scene(rng)
    n_feat = f_xy.shape[0]
    cam_c = np.asarray(-jnp.matmul(R.T, t))
    vec = X - cam_c
    dist = np.linalg.norm(vec, axis=1)
    normal = vec / dist[:, None]
    pm = matching.search_by_projection(
        cameras.PINHOLE, PIN, R, t, 320, 240,
        jnp.asarray(X), jnp.asarray(normal),
        jnp.asarray(dist * 0.5), jnp.asarray(dist),
        jnp.asarray(descs), jnp.ones(len(X), bool),
        jnp.asarray(f_xy), jnp.zeros(n_feat, jnp.int32),
        jnp.asarray(f_desc), jnp.ones(n_feat, bool),
        th_radius=3.0, nn_ratio=0.9, scale_factor=1.2, n_levels=8)
    slots = np.asarray(pm.mp_slot)
    # most true correspondences found, assigned to the right feature
    correct = sum(1 for i in range(n_pts) if slots[i] == i)
    assert correct > 0.8 * n_pts, correct
    # distractor features unmatched
    assert (slots[n_pts:] == -1).all()


def test_projection_matching_radius_gate(rng):
    X, descs, R, t, f_xy, f_desc, n_pts = make_scene(rng)
    n_feat = f_xy.shape[0]
    # shift all features far away: nothing should match at small radius
    f_xy2 = f_xy + 50.0
    cam_c = np.asarray(-jnp.matmul(R.T, t))
    vec = X - cam_c
    dist = np.linalg.norm(vec, axis=1)
    normal = vec / dist[:, None]
    pm = matching.search_by_projection(
        cameras.PINHOLE, PIN, R, t, 320, 240,
        jnp.asarray(X), jnp.asarray(normal),
        jnp.asarray(dist * 0.5), jnp.asarray(dist),
        jnp.asarray(descs), jnp.ones(len(X), bool),
        jnp.asarray(f_xy2), jnp.zeros(n_feat, jnp.int32),
        jnp.asarray(f_desc), jnp.ones(n_feat, bool),
        th_radius=3.0, nn_ratio=0.9, scale_factor=1.2, n_levels=8)
    assert int(pm.n_matches) == 0


def test_rotation_consistency_filter(rng):
    """Ref ORBmatcher rotation histogram (src/ORBmatcher.cc:35-37 + the
    rotHist blocks in each Search*): matches whose keypoint-angle delta
    disagrees with the dominant in-plane rotation are dropped."""
    n = 200
    # true in-plane rotation of 0.5 rad; 20 corrupted matches at random
    # inconsistent deltas
    angle_b = rng.uniform(0, 2 * np.pi, n).astype(np.float32)
    angle_a = np.mod(angle_b + 0.5, 2 * np.pi).astype(np.float32)
    idx_b = np.arange(n, dtype=np.int32)
    bad = rng.choice(n, 20, replace=False)
    # inconsistent deltas spread over [0.5+1.0, 0.5+2pi-1.0] — each bad
    # bin stays under the reference's 10%-of-max secondary-bin keep rule
    angle_a[bad] = np.mod(
        angle_b[bad] + 0.5 + rng.uniform(1.0, 2 * np.pi - 1.0, 20),
        2 * np.pi)
    # some features unmatched
    idx_b[:10] = -1
    out = np.asarray(matching.rotation_consistency(
        jnp.asarray(idx_b), jnp.asarray(angle_a), jnp.asarray(angle_b)))
    kept_bad = [i for i in bad if i >= 10 and out[i] >= 0]
    assert not kept_bad, kept_bad
    good = [i for i in range(10, n) if i not in set(bad.tolist())]
    # consistent matches survive
    assert all(out[i] == i for i in good)
    # unmatched stay unmatched
    assert (out[:10] == -1).all()


def test_mutual_match_angle_gate(rng):
    """mutual_match with angles: a descriptor-perfect but
    rotation-inconsistent match is rejected."""
    n = 64
    descs = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    angle_b = rng.uniform(0, 2 * np.pi, n).astype(np.float32)
    angle_a = np.mod(angle_b + 1.0, 2 * np.pi).astype(np.float32)
    # one feature's angle is flipped by pi -> inconsistent with the rest
    angle_a[7] = np.mod(angle_a[7] + np.pi, 2 * np.pi)
    valid = np.ones(n, bool)
    mm = matching.mutual_match(
        jnp.asarray(descs), jnp.asarray(valid),
        jnp.asarray(descs), jnp.asarray(valid),
        angle_a=jnp.asarray(angle_a), angle_b=jnp.asarray(angle_b))
    out = np.asarray(mm.idx_b)
    assert out[7] == -1
    assert (out[np.arange(n) != 7] == np.arange(n)[np.arange(n) != 7]).all()
