import jax.numpy as jnp
import numpy as np

from ms_slam.ops import lie, pose_graph


def circle_poses(n, radius=5.0):
    """Ground truth: camera going around a circle (Tcw convention)."""
    Rs, ts = [], []
    for k in range(n):
        a = 2 * np.pi * k / n
        # camera-to-world
        Rwc = np.asarray(lie.so3_exp(jnp.asarray([0.0, a, 0.0])))
        twc = np.array([radius * np.sin(a), 0.0, radius * (1 - np.cos(a))])
        Rcw = Rwc.T
        tcw = -Rcw @ twc
        Rs.append(Rcw)
        ts.append(tcw)
    return np.stack(Rs), np.stack(ts)


def test_loop_closure_removes_drift(rng):
    n = 24
    Rs, ts = circle_poses(n)
    # odometry chain with accumulating noise => drifted estimates
    R_est = [Rs[0]]
    t_est = [ts[0]]
    e_i, e_j, e_R, e_t = [], [], [], []
    for k in range(1, n):
        Rz, tz = pose_graph.relative_pose(
            jnp.asarray(Rs[k]), jnp.asarray(ts[k]),
            jnp.asarray(Rs[k - 1]), jnp.asarray(ts[k - 1]))
        # noisy odometry measurement
        noise = rng.normal(0, 0.01, 6)
        dR, dt_ = lie.se3_exp(jnp.asarray(noise))
        Rzn, tzn = lie.se3_compose(dR, dt_, Rz, tz)
        # integrate drifted estimate: T_k = Z_k,k-1 * T_k-1
        Rk, tk = lie.se3_compose(Rzn, tzn,
                                 jnp.asarray(R_est[-1]), jnp.asarray(t_est[-1]))
        R_est.append(np.asarray(Rk))
        t_est.append(np.asarray(tk))
        e_i.append(k)
        e_j.append(k - 1)
        e_R.append(np.asarray(Rzn))
        e_t.append(np.asarray(tzn))

    # drift before closing
    drift = np.linalg.norm(t_est[-1] - ts[-1])
    assert drift > 0.05, drift

    # loop edge with the TRUE relative pose (the Sim3/SE3 solver's output)
    Rz, tz = pose_graph.relative_pose(
        jnp.asarray(Rs[-1]), jnp.asarray(ts[-1]),
        jnp.asarray(Rs[0]), jnp.asarray(ts[0]))
    e_i.append(n - 1)
    e_j.append(0)
    e_R.append(np.asarray(Rz))
    e_t.append(np.asarray(tz))

    E = len(e_i)
    fixed = np.zeros(n, bool)
    fixed[0] = True
    res = pose_graph.optimize_pose_graph(
        jnp.asarray(np.stack(R_est)), jnp.asarray(np.stack(t_est)),
        jnp.asarray(fixed),
        jnp.asarray(e_i, dtype=jnp.int32), jnp.asarray(e_j, dtype=jnp.int32),
        jnp.asarray(np.stack(e_R)), jnp.asarray(np.stack(e_t)),
        jnp.ones(E), jnp.ones(E, bool), n_iters=15)

    err_before = np.linalg.norm(np.stack(t_est) - ts, axis=1)
    err_after = np.linalg.norm(np.asarray(res.t) - ts, axis=1)
    # end-of-loop error shrinks dramatically; mean error improves
    assert np.linalg.norm(np.asarray(res.t[-1]) - ts[-1]) < 0.35 * drift
    assert err_after.mean() < 0.7 * err_before.mean(), (
        err_after.mean(), err_before.mean())


def test_perfect_graph_stays_put(rng):
    n = 8
    Rs, ts = circle_poses(n)
    e_i = list(range(1, n))
    e_j = list(range(0, n - 1))
    e_R, e_t = [], []
    for k in range(1, n):
        Rz, tz = pose_graph.relative_pose(
            jnp.asarray(Rs[k]), jnp.asarray(ts[k]),
            jnp.asarray(Rs[k - 1]), jnp.asarray(ts[k - 1]))
        e_R.append(np.asarray(Rz))
        e_t.append(np.asarray(tz))
    fixed = np.zeros(n, bool)
    fixed[0] = True
    res = pose_graph.optimize_pose_graph(
        jnp.asarray(Rs), jnp.asarray(ts), jnp.asarray(fixed),
        jnp.asarray(e_i, dtype=jnp.int32), jnp.asarray(e_j, dtype=jnp.int32),
        jnp.asarray(np.stack(e_R)), jnp.asarray(np.stack(e_t)),
        jnp.ones(n - 1), jnp.ones(n - 1, bool), n_iters=5)
    np.testing.assert_allclose(res.t, ts, atol=1e-6)


def test_sim3_loop_absorbs_scale_drift(rng):
    """Monocular-style drift: odometry edges measured at a slowly growing
    scale; the Sim(3) graph with a scale-carrying loop edge must recover
    both the geometry and per-keyframe scale (ref OptimizeEssentialGraph
    bFixScale=false)."""
    n = 20
    Rs, ts = circle_poses(n)
    # simulate scale drift: each odometry edge's translation is scaled by a
    # factor that compounds to ~1.5x by loop end
    per_edge = 1.5 ** (1.0 / (n - 1))
    R_est = [Rs[0]]
    t_est = [ts[0]]
    e_i, e_j, e_s, e_R, e_t = [], [], [], [], []
    s_acc = 1.0
    for k in range(1, n):
        Rz, tz = pose_graph.relative_pose(
            jnp.asarray(Rs[k]), jnp.asarray(ts[k]),
            jnp.asarray(Rs[k - 1]), jnp.asarray(ts[k - 1]))
        s_acc *= per_edge           # local scale compounds with distance
        tz_drift = np.asarray(tz) * s_acc
        Rk, tk = lie.se3_compose(jnp.asarray(Rz), jnp.asarray(tz_drift),
                                 jnp.asarray(R_est[-1]),
                                 jnp.asarray(t_est[-1]))
        R_est.append(np.asarray(Rk))
        t_est.append(np.asarray(tk))
        e_i.append(k)
        e_j.append(k - 1)
        e_s.append(1.0)   # odometry believes scale 1
        e_R.append(np.asarray(Rz))
        e_t.append(np.asarray(tz_drift))

    drift = np.linalg.norm(t_est[-1] - ts[-1])
    assert drift > 0.3, drift

    # loop edge: true relative Sim3 (scale s_acc detected by the Sim3 solver)
    Rz, tz = pose_graph.relative_pose(
        jnp.asarray(Rs[-1]), jnp.asarray(ts[-1]),
        jnp.asarray(Rs[0]), jnp.asarray(ts[0]))
    e_i.append(n - 1)
    e_j.append(0)
    e_s.append(1.0)
    e_R.append(np.asarray(Rz))
    e_t.append(np.asarray(tz))

    E = len(e_i)
    fixed = np.zeros(n, bool)
    fixed[0] = True
    res = pose_graph.optimize_pose_graph_sim3(
        jnp.ones(n), jnp.asarray(np.stack(R_est)),
        jnp.asarray(np.stack(t_est)), jnp.asarray(fixed),
        jnp.asarray(e_i, dtype=jnp.int32), jnp.asarray(e_j, dtype=jnp.int32),
        jnp.asarray(e_s), jnp.asarray(np.stack(e_R)),
        jnp.asarray(np.stack(e_t)),
        jnp.ones(E), jnp.ones(E, bool), n_iters=20)

    # loop end snaps back and the graph distributes the scale error:
    # compare similarity-normalized positions (divide translation by scale)
    t_corr = np.asarray(res.t) / np.asarray(res.s)[:, None]
    end_err = np.linalg.norm(t_corr[-1] - ts[-1])
    assert end_err < 0.25 * drift, (end_err, drift)
    assert np.isfinite(np.asarray(res.s)).all()
    # scale variables move away from 1 to absorb the drift
    assert np.abs(np.log(np.asarray(res.s))).max() > 0.05


def test_4dof_graph_removes_yaw_drift_preserves_gravity(rng):
    """Inertial essential graph (ref OptimizeEssentialGraph4DoF,
    src/Optimizer.cc:5174): yaw+translation drift around a loop is
    removed while the gravity direction in every camera frame is exactly
    unchanged (pitch/roll are not optimizable once the IMU fixed them)."""
    n = 20
    Rs, ts = circle_poses(n)          # rotation about world y => up = +y
    up = np.array([0.0, 1.0, 0.0], np.float32)
    R_est = [Rs[0]]
    t_est = [ts[0]]
    e_i, e_j, e_R, e_t = [], [], [], []
    for k in range(1, n):
        Rz, tz = pose_graph.relative_pose(
            jnp.asarray(Rs[k]), jnp.asarray(ts[k]),
            jnp.asarray(Rs[k - 1]), jnp.asarray(ts[k - 1]))
        # yaw-only rotational drift (about up) + translation noise: the
        # kind of drift a gravity-aligned VIO system accumulates
        dyaw = rng.normal(0, 0.01)
        dR = np.asarray(lie.so3_exp(jnp.asarray(up * dyaw)))
        Rzn = np.asarray(Rz) @ dR
        tzn = np.asarray(tz) + rng.normal(0, 0.01, 3)
        Rk, tk = lie.se3_compose(jnp.asarray(Rzn), jnp.asarray(tzn),
                                 jnp.asarray(R_est[-1]),
                                 jnp.asarray(t_est[-1]))
        R_est.append(np.asarray(Rk))
        t_est.append(np.asarray(tk))
        e_i.append(k)
        e_j.append(k - 1)
        e_R.append(Rzn)
        e_t.append(tzn)
    drift = np.linalg.norm(t_est[-1] - ts[-1])
    assert drift > 0.03, drift

    Rz, tz = pose_graph.relative_pose(
        jnp.asarray(Rs[-1]), jnp.asarray(ts[-1]),
        jnp.asarray(Rs[0]), jnp.asarray(ts[0]))
    e_i.append(n - 1)
    e_j.append(0)
    e_R.append(np.asarray(Rz))
    e_t.append(np.asarray(tz))
    E = len(e_i)
    fixed = np.zeros(n, bool)
    fixed[0] = True
    res = pose_graph.optimize_pose_graph_4dof(
        jnp.asarray(np.stack(R_est)), jnp.asarray(np.stack(t_est)),
        jnp.asarray(up), jnp.asarray(fixed),
        jnp.asarray(e_i, dtype=jnp.int32), jnp.asarray(e_j, dtype=jnp.int32),
        jnp.asarray(np.stack(e_R)), jnp.asarray(np.stack(e_t)),
        jnp.ones(E), jnp.ones(E, bool), n_iters=15)

    # loop end error shrinks
    end_err = np.linalg.norm(np.asarray(res.t[-1]) - ts[-1])
    assert end_err < 0.4 * drift, (end_err, drift)
    # gravity direction in each camera frame is EXACTLY preserved (up to
    # float roundoff): the 4-DoF update cannot rotate about any other axis
    g_before = np.einsum("kij,j->ki", np.stack(R_est), up)
    g_after = np.einsum("kij,j->ki", np.asarray(res.R), up)
    np.testing.assert_allclose(g_after, g_before, atol=5e-5)
