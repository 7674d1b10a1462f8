"""inertial_window_refine: inertial chain + fixed landmarks recover
perturbed window states."""
import jax
import jax.numpy as jnp
import numpy as np

from ms_slam.ops import cameras, imu, inertial_opt, lie

from test_imu import simulate, G

PIN = cameras.pad_params([350.0, 350.0, 320.0, 240.0])
BF = 50.0


def test_window_refine(rng):
    W = 5
    seg = 40
    meas, Rs, vs, ps = simulate(rng, n=(W - 1) * seg, dt=0.005)
    kf_R = np.stack([Rs[i * seg] for i in range(W)])
    kf_p = np.stack([ps[i * seg] for i in range(W)])
    kf_v = np.stack([vs[i * seg] for i in range(W)])
    sts = []
    for i in range(W - 1):
        chunk = meas[i * seg:(i + 1) * seg]
        sts.append(imu.integrate(jnp.zeros(6), jnp.asarray(chunk),
                                 jnp.ones(seg, bool), jnp.asarray(1e-3),
                                 jnp.asarray(1e-2), jnp.asarray(1e-6),
                                 jnp.asarray(1e-5)))
    stack = jax.tree.map(lambda *a: jnp.stack(a), *sts)

    # landmarks + observations from every window keyframe
    n_pts = 150
    X = rng.uniform(-4, 4, (n_pts, 3))
    X[:, 2] += 10.0
    f_kf, f_uv, f_ur, ok = [], [], [], []
    for k in range(W):
        R_cw = kf_R[k].T
        t_cw = -R_cw @ kf_p[k]
        Xc = (R_cw @ X.T).T + t_cw
        uv = np.array(cameras.pinhole_project(PIN, jnp.asarray(Xc)))
        uv += rng.normal(0, 0.3, uv.shape)
        for p_i in range(n_pts):
            f_kf.append(k)
            f_uv.append(uv[p_i])
            f_ur.append(uv[p_i, 0] - BF / max(Xc[p_i, 2], 0.1))
            ok.append(Xc[p_i, 2] > 1)
    F = len(f_kf)
    X_f = np.stack([X[i % n_pts] for i in range(F)])

    # perturb all but the first keyframe
    Rp, pp, vp = kf_R.copy(), kf_p.copy(), kf_v.copy()
    for k in range(1, W):
        dR = np.asarray(lie.so3_exp(jnp.asarray(rng.normal(0, 0.01, 3))))
        Rp[k] = dR @ kf_R[k]
        pp[k] = kf_p[k] + rng.normal(0, 0.05, 3)
        vp[k] = kf_v[k] + rng.normal(0, 0.1, 3)

    res = inertial_opt.inertial_window_refine(
        cameras.PINHOLE, PIN, jnp.asarray(BF),
        jnp.asarray(Rp), jnp.asarray(pp), jnp.asarray(vp),
        jnp.ones(W, bool), stack, jnp.ones(W - 1, bool),
        jnp.zeros(3), jnp.zeros(3), jnp.asarray(G),
        jnp.asarray(X_f), jnp.asarray(f_kf, dtype=jnp.int32),
        jnp.asarray(np.asarray(f_uv)), jnp.asarray(np.asarray(f_ur)),
        jnp.ones(F), jnp.asarray(ok),
        walk_info=jnp.full(6, 1e6))

    for k in range(1, W):
        dR = np.asarray(res.R_wb[k]) @ kf_R[k].T
        ang = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
        perr = np.linalg.norm(np.asarray(res.p_wb[k]) - kf_p[k])
        verr = np.linalg.norm(np.asarray(res.vels[k]) - kf_v[k])
        assert ang < 0.1, (k, ang)
        assert perr < 0.02, (k, perr)
        assert verr < 0.05, (k, verr)


def test_window_refine_with_tbc(rng):
    """Non-identity body-from-camera extrinsic: observations generated from
    the camera pose T_wc = T_wb * T_bc must be consistent under refinement."""
    W = 4
    seg = 40
    meas, Rs, vs, ps = simulate(rng, n=(W - 1) * seg, dt=0.005)
    kf_R = np.stack([Rs[i * seg] for i in range(W)])
    kf_p = np.stack([ps[i * seg] for i in range(W)])
    kf_v = np.stack([vs[i * seg] for i in range(W)])
    sts = []
    for i in range(W - 1):
        chunk = meas[i * seg:(i + 1) * seg]
        sts.append(imu.integrate(jnp.zeros(6), jnp.asarray(chunk),
                                 jnp.ones(seg, bool), jnp.asarray(1e-3),
                                 jnp.asarray(1e-2), jnp.asarray(1e-6),
                                 jnp.asarray(1e-5)))
    stack = jax.tree.map(lambda *a: jnp.stack(a), *sts)

    R_bc = np.asarray(lie.so3_exp(jnp.asarray([0.05, -0.4, 0.1])))
    t_bc = np.array([0.1, -0.06, 0.02])

    n_pts = 120
    X = rng.uniform(-4, 4, (n_pts, 3))
    X[:, 2] += 10.0
    f_kf, f_uv, f_ur, ok = [], [], [], []
    for k in range(W):
        R_wc = kf_R[k] @ R_bc
        p_wc = kf_R[k] @ t_bc + kf_p[k]
        R_cw = R_wc.T
        t_cw = -R_cw @ p_wc
        Xc = (R_cw @ X.T).T + t_cw
        uv = np.array(cameras.pinhole_project(PIN, jnp.asarray(Xc)))
        uv += rng.normal(0, 0.3, uv.shape)
        for p_i in range(n_pts):
            f_kf.append(k)
            f_uv.append(uv[p_i])
            f_ur.append(uv[p_i, 0] - BF / max(Xc[p_i, 2], 0.1))
            ok.append(Xc[p_i, 2] > 1)
    F = len(f_kf)
    X_f = np.stack([X[i % n_pts] for i in range(F)])

    Rp, pp, vp = kf_R.copy(), kf_p.copy(), kf_v.copy()
    for k in range(1, W):
        dR = np.asarray(lie.so3_exp(jnp.asarray(rng.normal(0, 0.01, 3))))
        Rp[k] = dR @ kf_R[k]
        pp[k] = kf_p[k] + rng.normal(0, 0.05, 3)
        vp[k] = kf_v[k] + rng.normal(0, 0.1, 3)

    res = inertial_opt.inertial_window_refine(
        cameras.PINHOLE, PIN, jnp.asarray(BF),
        jnp.asarray(Rp), jnp.asarray(pp), jnp.asarray(vp),
        jnp.ones(W, bool), stack, jnp.ones(W - 1, bool),
        jnp.zeros(3), jnp.zeros(3), jnp.asarray(G),
        jnp.asarray(X_f), jnp.asarray(f_kf, dtype=jnp.int32),
        jnp.asarray(np.asarray(f_uv)), jnp.asarray(np.asarray(f_ur)),
        jnp.ones(F), jnp.asarray(ok),
        walk_info=jnp.full(6, 1e6),
        R_bc=jnp.asarray(R_bc), t_bc=jnp.asarray(t_bc))

    for k in range(1, W):
        dR = np.asarray(res.R_wb[k]) @ kf_R[k].T
        ang = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
        perr = np.linalg.norm(np.asarray(res.p_wb[k]) - kf_p[k])
        assert ang < 0.15, (k, ang)
        assert perr < 0.03, (k, perr)


def test_vi_window_ba_recovers_poses_and_points(rng):
    """vi_window_ba (the LocalInertialBA analog with FREE landmarks,
    ref src/Optimizer.cc:2431): perturbed window poses, velocities AND
    landmark positions must all be pulled back to ground truth."""
    W = 5
    seg = 40
    meas, Rs, vs, ps = simulate(rng, n=(W - 1) * seg, dt=0.005)
    kf_R = np.stack([Rs[i * seg] for i in range(W)])
    kf_p = np.stack([ps[i * seg] for i in range(W)])
    kf_v = np.stack([vs[i * seg] for i in range(W)])
    sts = []
    for i in range(W - 1):
        chunk = meas[i * seg:(i + 1) * seg]
        sts.append(imu.integrate(jnp.zeros(6), jnp.asarray(chunk),
                                 jnp.ones(seg, bool), jnp.asarray(1e-3),
                                 jnp.asarray(1e-2), jnp.asarray(1e-6),
                                 jnp.asarray(1e-5)))
    stack = jax.tree.map(lambda *a: jnp.stack(a), *sts)

    n_pts = 150
    X = rng.uniform(-4, 4, (n_pts, 3))
    X[:, 2] += 10.0
    f_kf, f_pt, f_uv, f_ur, ok = [], [], [], [], []
    for k in range(W):
        R_cw = kf_R[k].T
        t_cw = -R_cw @ kf_p[k]
        Xc = (R_cw @ X.T).T + t_cw
        uv = np.array(cameras.pinhole_project(PIN, jnp.asarray(Xc)))
        uv += rng.normal(0, 0.05, uv.shape)
        for p_i in range(n_pts):
            f_kf.append(k)
            f_pt.append(p_i)
            f_uv.append(uv[p_i])
            f_ur.append(uv[p_i, 0] - BF / max(Xc[p_i, 2], 0.1))
            ok.append(Xc[p_i, 2] > 1)
    F = len(f_kf)

    Rp, pp, vp = kf_R.copy(), kf_p.copy(), kf_v.copy()
    for k in range(1, W):
        dR = np.asarray(lie.so3_exp(jnp.asarray(rng.normal(0, 0.01, 3))))
        Rp[k] = dR @ kf_R[k]
        pp[k] = kf_p[k] + rng.normal(0, 0.05, 3)
        vp[k] = kf_v[k] + rng.normal(0, 0.1, 3)
    Xp = X + rng.normal(0, 0.05, X.shape)

    # no anchors (empty)
    Ac = 1
    res = inertial_opt.vi_window_ba(
        cameras.PINHOLE, PIN, jnp.asarray(BF),
        jnp.asarray(Rp), jnp.asarray(pp), jnp.asarray(vp),
        jnp.ones(W, bool), stack, jnp.ones(W - 1, bool),
        jnp.zeros(3), jnp.zeros(3), jnp.asarray(G),
        jnp.asarray(Xp),
        jnp.asarray(f_pt, dtype=jnp.int32),
        jnp.asarray(f_kf, dtype=jnp.int32),
        jnp.asarray(np.asarray(f_uv)), jnp.asarray(np.asarray(f_ur)),
        jnp.ones(F), jnp.asarray(ok),
        jnp.tile(jnp.eye(3), (Ac, 1, 1)), jnp.zeros((Ac, 3)),
        jnp.zeros(1, jnp.int32), jnp.zeros(1, jnp.int32),
        jnp.zeros((1, 2)), jnp.full(1, -1.0), jnp.ones(1),
        jnp.zeros(1, bool),
        walk_info=jnp.full(6, 1e6))

    for k in range(1, W):
        dR = np.asarray(res.R_wb[k]) @ kf_R[k].T
        ang = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
        perr = np.linalg.norm(np.asarray(res.p_wb[k]) - kf_p[k])
        verr = np.linalg.norm(np.asarray(res.vels[k]) - kf_v[k])
        assert ang < 0.2, (k, ang)
        assert perr < 0.05, (k, perr)
        assert verr < 0.1, (k, verr)
    # landmarks pulled back toward truth (started at 0.05 rms offset)
    X_new = np.asarray(res.mp_pos)
    err0 = np.linalg.norm(Xp - X, axis=1).mean()
    err1 = np.linalg.norm(X_new - X, axis=1).mean()
    assert err1 < 0.5 * err0, (err0, err1)
