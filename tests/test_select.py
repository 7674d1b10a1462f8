"""Selector quality vs the exact ILP (scipy HiGHS stands in for GUROBI).

Covers both the toy regime (exact-optimum checks on 8 seeds) and a FULL
reference-scale instance — K=30 window rows + 8 out-of-window observers,
N=2048 feature slots, 64x48 grid, N_req=100, lambda=500, lambda_grid=10
(the KITTI-00 parameterization, /root/reference/Examples/Stereo/
KITTI00-02.yaml:69-75) — where round-4's union repair kept ~80% of points
while the exact ILP keeps ~10-15% (VERDICT r4)."""
import numpy as np
import jax.numpy as jnp
import pytest

from ms_slam.ops import select


def random_instance(rng, K=4, N=24, P=40, n_cells=8, req=6):
    """Small window: K KFs x N feature slots over P points, cells 0..n_cells."""
    obs_pt = np.full((K, N), -1, np.int32)
    obs_cell = np.zeros((K, N), np.int32)
    for k in range(K):
        n_obs = rng.integers(N // 2, N)
        pts = rng.choice(P, size=n_obs, replace=False)
        obs_pt[k, :n_obs] = pts
        obs_cell[k, :n_obs] = rng.integers(0, n_cells, n_obs)
    obs_valid = obs_pt >= 0
    # cost = maxObs - obs count
    counts = np.zeros(P, int)
    for p, c in zip(*np.unique(obs_pt[obs_pt >= 0], return_counts=True)):
        counts[p] = c
    cost = (counts.max() - counts).astype(np.float64)
    p_valid = counts > 0
    req_kf = np.full(K, req, np.int32)
    return obs_pt, obs_cell, obs_valid, cost, p_valid, req_kf


def reference_scale_instance(rng):
    """Track-structured window at the KITTI parameterization: 30 window
    KFs x 2048 features with a HEAVY-TAILED track-length distribution
    (most ORB points track 2-8 keyframes, a small fraction track 20-35) —
    that tail sets maxObs, which pushes typical point costs well above
    lambda_grid, the regime where the exact ILP pays cell slack freely
    and keeps ~10% of points (ref README.md:49). Plus 8 pro-rated
    out-of-window observer rows whose cells carry no grid constraint
    (obs_cell = n_cells sentinel, matching pipeline/sparsification.py)."""
    Kw, Ko, N, n_cells = 30, 8, 2048, 64 * 48
    K = Kw + Ko
    P = 10240
    # births uniform over an extended window; lengths geometric w/ long tail
    length = 2 + rng.geometric(0.25, size=P)
    long_track = rng.random(P) < 0.05
    length[long_track] = rng.integers(20, 36, long_track.sum())
    birth = rng.integers(-34, Kw, size=P)
    obs_pt = np.full((K, N), -1, np.int32)
    obs_cell = np.full((K, N), n_cells, np.int32)
    for k in range(Kw):
        seen = np.nonzero((birth <= k) & (k < birth + length))[0]
        if len(seen) > N:
            seen = rng.choice(seen, size=N, replace=False)
        obs_pt[k, :len(seen)] = seen
        # features cluster on texture: each KF occupies ~700 of the 3072
        # cells with ~3 observations per occupied cell (real-image ORB
        # grids share cells; a uniform draw would make every point a sole
        # cover, which is not the KITTI regime)
        active = rng.choice(n_cells, 700, replace=False)
        obs_cell[k, :len(seen)] = active[rng.integers(0, 700, len(seen))]
    for j in range(Ko):
        k = Kw + j
        # an out-of-window KF sees a random slice of the older points
        pool = np.nonzero(birth < Kw // 2)[0]
        n_obs = int(rng.integers(N // 4, N // 2))
        obs_pt[k, :n_obs] = rng.choice(pool, size=n_obs, replace=False)
    obs_valid = obs_pt >= 0
    counts = np.zeros(P, int)
    for p, c in zip(*np.unique(obs_pt[obs_pt >= 0], return_counts=True)):
        counts[p] = c
    # the reference's cost uses each point's TOTAL observation count (ref
    # MapSparsification.cc:67-76 via MapPoint::Observations) — long-lived
    # points carry many observations outside this window, which sets
    # maxObs far above the typical in-window multiplicity and pushes most
    # costs above lambda_grid (the regime where the ILP pays cell slack)
    extra = np.where(long_track, rng.integers(10, 40, P), 0)
    total = np.where(counts > 0, counts + extra, 0)
    cost = (total.max() - total).astype(np.float64)
    p_valid = counts > 0
    req_kf = np.concatenate([np.full(Kw, 100),
                             rng.integers(20, 80, Ko)]).astype(np.int32)
    return obs_pt, obs_cell, obs_valid, cost, p_valid, req_kf, n_cells


def exact_ilp(obs_pt, obs_cell, obs_valid, cost, p_valid, req_kf,
              lam, lam_grid, n_cells, mip_rel_gap=0.0, time_limit=None):
    """Reference solver via scipy.milp (the GUROBI stand-in). Vectorized
    constraint assembly so reference-scale instances (~45k cell rows)
    build in milliseconds."""
    from scipy.optimize import milp, LinearConstraint, Bounds
    import scipy.sparse as sp
    K, N = obs_pt.shape
    P = cost.shape[0]
    ok = obs_valid & (obs_pt >= 0)
    kk, ii = np.nonzero(ok)
    pts = obs_pt[kk, ii]
    cells = obs_cell[kk, ii]
    priced = (cells >= 0) & (cells < n_cells)
    occ, occ_inv = np.unique(kk[priced] * n_cells + cells[priced],
                             return_inverse=True)
    C = len(occ)
    nv = P + K + C
    c_vec = np.concatenate([np.asarray(cost, float), np.full(K, float(lam)),
                            np.full(C, float(lam_grid))])
    rows = np.concatenate([kk, np.arange(K)])
    cols = np.concatenate([pts, P + np.arange(K)])
    A1 = sp.csr_matrix((np.ones(len(rows)), (rows, cols)), shape=(K, nv))
    rows2 = np.concatenate([occ_inv, np.arange(C)])
    cols2 = np.concatenate([pts[priced], P + K + np.arange(C)])
    A2 = sp.csr_matrix((np.ones(len(rows2)), (rows2, cols2)), shape=(C, nv))
    A = sp.vstack([A1, A2]).tocsr()
    lo = np.concatenate([np.asarray(req_kf, float), np.ones(C)])
    opts = {}
    if time_limit:
        opts["time_limit"] = time_limit
    if mip_rel_gap:
        opts["mip_rel_gap"] = mip_rel_gap
    res = milp(c_vec,
               constraints=LinearConstraint(A, lo, np.inf),
               bounds=Bounds(0, np.concatenate(
                   [np.ones(P), np.full(K + C, np.inf)])),
               integrality=np.concatenate(
                   [np.ones(P), np.zeros(K + C)]),
               options=opts)
    assert res.x is not None, res.message
    return res.x[:P] > 0.5, res.fun


class TestSelector:
    @pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5, 6, 7])
    def test_near_optimal_vs_ilp(self, seed):
        rng = np.random.default_rng(seed)
        inst = random_instance(rng)
        obs_pt, obs_cell, obs_valid, cost, p_valid, req_kf = inst
        lam, lam_grid, n_cells = 100.0, 5.0, 8

        res = select.select_points(
            jnp.asarray(obs_pt), jnp.asarray(obs_cell), jnp.asarray(obs_valid),
            jnp.asarray(cost, jnp.float32), jnp.asarray(p_valid),
            jnp.asarray(req_kf), lam=lam, lam_grid=lam_grid, n_cells=n_cells)

        ours = float(select.selection_cost(
            res.keep, jnp.asarray(cost, jnp.float32), res.kf_cover,
            jnp.asarray(req_kf), lam, jnp.asarray(obs_pt),
            jnp.asarray(obs_cell), jnp.asarray(obs_valid), lam_grid, n_cells))
        _, opt = exact_ilp(obs_pt, obs_cell, obs_valid, cost, p_valid,
                           req_kf, lam, lam_grid, n_cells)
        # near-optimality gate (reference tolerance is MIPGap 0.002)
        assert ours <= 1.1 * max(opt, 1.0) + 1e-6, (ours, opt)

    @pytest.mark.slow
    def test_reference_scale_vs_ilp(self):
        """VERDICT r4 #1 done-criterion: at K=38 rows / N=2048 / 64x48
        grid / N_req=100 the selection must be <=1.1x the exact ILP
        objective AND keep at most 1.5x the ILP's point fraction."""
        rng = np.random.default_rng(0)
        (obs_pt, obs_cell, obs_valid, cost, p_valid, req_kf,
         n_cells) = reference_scale_instance(rng)
        lam, lam_grid = 500.0, 10.0

        res = select.select_points(
            jnp.asarray(obs_pt), jnp.asarray(obs_cell), jnp.asarray(obs_valid),
            jnp.asarray(cost, jnp.float32), jnp.asarray(p_valid),
            jnp.asarray(req_kf), lam=lam, lam_grid=lam_grid, n_cells=n_cells)
        keep = np.asarray(res.keep)

        ours = float(select.selection_cost(
            res.keep, jnp.asarray(cost, jnp.float32), res.kf_cover,
            jnp.asarray(req_kf), lam, jnp.asarray(obs_pt),
            jnp.asarray(obs_cell), jnp.asarray(obs_valid), lam_grid, n_cells))
        ilp_keep, opt = exact_ilp(
            obs_pt, obs_cell, obs_valid, cost, p_valid, req_kf,
            lam, lam_grid, n_cells, mip_rel_gap=0.002, time_limit=600)

        n_pts = int(p_valid.sum())
        kept_ours = keep.sum() / n_pts
        kept_ilp = ilp_keep.sum() / n_pts
        assert ours <= 1.1 * opt + 1e-6, (ours, opt)
        assert kept_ours <= max(1.5 * kept_ilp, kept_ilp + 0.01), (
            kept_ours, kept_ilp)
        # feasibility: per-row coverage met wherever enough points exist
        cover = np.asarray(res.kf_cover)
        avail = (obs_pt >= 0).sum(axis=1)
        assert (cover >= np.minimum(req_kf, avail)).all()

    def test_constraints_satisfied_when_feasible(self, rng):
        obs_pt, obs_cell, obs_valid, cost, p_valid, req_kf = random_instance(
            rng, K=3, N=30, P=50, req=5)
        res = select.select_points(
            jnp.asarray(obs_pt), jnp.asarray(obs_cell), jnp.asarray(obs_valid),
            jnp.asarray(cost, jnp.float32), jnp.asarray(p_valid),
            jnp.asarray(req_kf))
        cover = np.asarray(res.kf_cover)
        avail = (obs_pt >= 0).sum(axis=1)
        want = np.minimum(np.asarray(req_kf), avail)
        assert (cover >= want).all(), (cover, want)
        # every occupied cell covered (all point costs here are below the
        # default lambda_grid=10, so the price-aware repair covers all)
        K, N = obs_pt.shape
        keep = np.asarray(res.keep)
        for k in range(K):
            cells = {}
            for i in range(N):
                if obs_pt[k, i] >= 0:
                    cells.setdefault(obs_cell[k, i], []).append(obs_pt[k, i])
            for cell, pts in cells.items():
                assert any(keep[p] for p in pts), (k, cell)

    def test_cell_slack_paid_when_expensive(self):
        """The lambda_grid constraint is priced, not hard (ref
        MapSparsification.cc:111-116): a cell whose only covering point
        costs more than lambda_grid is left uncovered."""
        K, N, P = 2, 6, 8
        obs_pt = np.full((K, N), -1, np.int32)
        obs_cell = np.zeros((K, N), np.int32)
        # row 0: points 0,1 (shared, cheap) in cell 0; point 2 (expensive,
        # seen once) alone in cell 1
        obs_pt[0, :3] = [0, 1, 2]
        obs_cell[0, :3] = [0, 0, 1]
        obs_pt[1, :2] = [0, 1]
        obs_cell[1, :2] = [0, 0]
        obs_valid = obs_pt >= 0
        counts = np.zeros(P, int)
        for p, c in zip(*np.unique(obs_pt[obs_pt >= 0], return_counts=True)):
            counts[p] = c
        cost = (counts.max() - counts).astype(np.float64)  # point 2: cost 1
        cost[2] = 50.0                                     # force expensive
        res = select.select_points(
            jnp.asarray(obs_pt), jnp.asarray(obs_cell), jnp.asarray(obs_valid),
            jnp.asarray(cost, jnp.float32), jnp.asarray(counts > 0),
            jnp.asarray(np.full(K, 2, np.int32)), lam=500.0, lam_grid=10.0,
            n_cells=4)
        keep = np.asarray(res.keep)
        assert keep[0] and keep[1]
        assert not keep[2]      # paying lambda_grid=10 beats cost 50

    def test_prefers_shared_points(self, rng):
        """Points observed by many KFs (low cost) should be preferred."""
        K, N, P = 3, 8, 12
        obs_pt = np.full((K, N), -1, np.int32)
        # points 0..3 seen by all KFs; 4..11 seen once each
        for k in range(K):
            obs_pt[k, :4] = [0, 1, 2, 3]
        obs_pt[0, 4:8] = [4, 5, 6, 7]
        obs_pt[1, 4:8] = [8, 9, 10, 11]
        obs_cell = np.zeros((K, N), np.int32)
        obs_valid = obs_pt >= 0
        counts = np.zeros(P, int)
        for p, c in zip(*np.unique(obs_pt[obs_pt >= 0], return_counts=True)):
            counts[p] = c
        cost = (counts.max() - counts).astype(np.float32)
        res = select.select_points(
            jnp.asarray(obs_pt), jnp.asarray(obs_cell), jnp.asarray(obs_valid),
            jnp.asarray(cost), jnp.asarray(counts > 0),
            jnp.asarray(np.full(K, 4, np.int32)), lam=100.0, lam_grid=0.5,
            n_cells=1)
        keep = np.asarray(res.keep)
        assert keep[:4].all()  # the shared points
