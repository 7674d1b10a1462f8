"""Cross-device parity checks: run one computation on two devices (the GPU
and the CPU backend, as a rule) and compare the results within tolerances
that the arithmetic justifies. Each check raises AssertionError with the
measured numbers when a tolerance is exceeded, and otherwise returns them.

Sums on a GPU are taken in another order than on the CPU, and scatters
with atomics in an order that changes between runs, so nothing here is
compared bitwise except integer results that are exact by construction.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import ba, cameras, hamming, lie, orb, pose_opt


def _require(ok: bool, what: dict):
    """A failed check raises (kept under python -O, unlike assert)."""
    if not ok:
        raise AssertionError(what)


def _on(dev, fn, *args):
    """fn(*args) with every input committed to `dev`, results on the host."""
    args = jax.device_put(args, dev)
    return jax.device_get(fn(*args))


def orb_parity(dev, ref_dev, imgs: np.ndarray, cfg: orb.OrbConfig,
               min_hit: float = 0.98, max_bit_frac: float = 0.01) -> dict:
    """ORB extraction (extract_canvas_multi) on a (B,H,W) image batch.

    Keypoints: every octave-0 keypoint of the reference, and at least
    `min_hit` of all its valid keypoints, have a keypoint at the same level
    pixel and octave. Octave 0 is integer arithmetic and must agree
    exactly; the coarser octaves are bilinear resamples whose sums run in
    another order on each backend, so FAST scores there differ in the last
    bits and near-tied candidates can swap (1.5% of keypoints at KITTI
    widths on an H100). Descriptors of matched pairs: median Hamming
    distance 0, and at most `max_bit_frac` of all their bits differ — a
    BRIEF test flips only where two blurred sums tie within
    summation-order rounding."""
    fn = jax.jit(partial(orb.extract_canvas_multi, cfg=cfg))
    imgs = np.asarray(imgs, np.float32)
    f_dev, _ = _on(dev, fn, imgs)
    f_ref, _ = _on(ref_dev, fn, imgs)
    scales = np.asarray(cfg.level_scales(), np.float64)
    hits = total = 0
    hams = []
    misses = np.zeros(cfg.n_levels, np.int64)
    for b in range(imgs.shape[0]):
        def keys(f):
            v = np.asarray(f.valid[b])
            oc = np.asarray(f.octave[b])[v]
            lvl = np.rint(np.asarray(f.xy[b], np.float64)[v]
                          / scales[oc][:, None]).astype(np.int64)
            return {(int(o), int(x), int(y)): d for o, (x, y), d in
                    zip(oc, lvl, np.asarray(f.desc[b])[v])}
        k_dev, k_ref = keys(f_dev), keys(f_ref)
        total += len(k_ref)
        for k, d_ref in k_ref.items():
            d_dev = k_dev.get(k)
            if d_dev is None:
                misses[k[0]] += 1
            else:
                hits += 1
                hams.append(int(np.unpackbits(
                    (d_ref ^ d_dev).view(np.uint8)).sum()))
    hams = np.asarray(hams)
    out = {"keypoints": total,
           "hit_frac": hits / max(total, 1),
           "median_hamming": float(np.median(hams)) if len(hams) else -1.0,
           "bit_frac": float(hams.sum()) / max(256 * len(hams), 1),
           "misses_by_octave": misses.tolist()}
    _require(total > 0, out)
    _require(misses[0] == 0, out)
    _require(out["hit_frac"] >= min_hit, out)
    _require(out["median_hamming"] == 0, out)
    _require(out["bit_frac"] <= max_bit_frac, out)
    return out


def hamming_parity(dev, ref_dev, n: int = 2048, m: int = 8192,
                   seed: int = 0) -> dict:
    """hamming_matrix on random descriptors: exact equality (+-1 bf16
    products summed in f32 are exact integers up to 2^24)."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
    b = rng.integers(0, 2 ** 32, (m, 8), dtype=np.uint32)
    fn = jax.jit(hamming.hamming_matrix)
    h_dev = np.asarray(_on(dev, fn, a, b))
    h_ref = np.asarray(_on(ref_dev, fn, a, b))
    out = {"shape": list(h_ref.shape),
           "mismatches": int(np.sum(h_dev != h_ref))}
    _require(out["mismatches"] == 0, out)
    return out


def pose_opt_parity(dev, ref_dev, n: int = 2048, seed: int = 0,
                    tol: float = 1e-5) -> dict:
    """pose_optimize on a stereo problem with 10% outliers: rotation and
    translation agree to `tol`."""
    rng = np.random.default_rng(seed)
    pin = cameras.pad_params([718.856, 718.856, 620.5, 188.0])
    bf = 386.1448
    X = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    X[:, 2] = rng.uniform(4, 40, n)
    xi = np.array([0.2, -0.1, 0.05, 0.03, -0.02, 0.04], np.float32)
    R, t = lie.se3_exp(jnp.asarray(xi))
    Xc = np.asarray(lie.se3_apply(R, t, jnp.asarray(X)))
    uv = np.asarray(cameras.pinhole_project(pin, jnp.asarray(Xc)))
    ur = uv[:, 0] - bf / Xc[:, 2]
    uv = (uv + rng.normal(0, 0.5, (n, 2))).astype(np.float32)
    ur = (ur + rng.normal(0, 0.5, n)).astype(np.float32)
    out_idx = rng.choice(n, n // 10, replace=False)
    uv[out_idx] += rng.uniform(20, 80, (len(out_idx), 2)).astype(np.float32)
    R0, t0 = lie.se3_exp(jnp.asarray(
        xi + np.array([0.05, -0.03, 0.04, 0.005, 0.005, -0.005], np.float32)))
    fn = jax.jit(partial(pose_opt.pose_optimize, cameras.PINHOLE))
    args = (np.asarray(pin, np.float32), np.float32(bf),
            np.asarray(R0, np.float32), np.asarray(t0, np.float32), X, uv,
            ur, np.ones(n, np.float32), np.ones(n, bool))
    r_dev = _on(dev, fn, *args)
    r_ref = _on(ref_dev, fn, *args)
    out = {"n": n,
           "max_dR": float(np.abs(r_dev.R - r_ref.R).max()),
           "max_dt": float(np.abs(r_dev.t - r_ref.t).max()),
           "inliers": [int(r_dev.n_inliers), int(r_ref.n_inliers)]}
    _require(min(out["inliers"]) >= 0.8 * n, out)      # a converged solve
    _require(out["max_dR"] <= tol and out["max_dt"] <= tol, out)
    return out


def ba_window(n_cams: int, n_feat: int, n_pts: int, seed: int = 0):
    """A local-BA-shaped problem: (C, N) camera-blocked factor table as the
    pipeline's window BA builds it, first third of the cameras fixed,
    perturbed poses and points. Returns the ba_solve positional args."""
    rng = np.random.default_rng(seed)
    pin = cameras.pad_params([718.856, 718.856, 620.5, 188.0])
    bf = 386.1448
    P = rng.uniform(-10, 10, (n_pts, 3)).astype(np.float32)
    P[:, 1] *= 0.3
    P[:, 2] = rng.uniform(6, 40, n_pts)
    Rs, ts = [], []
    for c in range(n_cams):
        R, t = lie.se3_exp(jnp.asarray(
            [0.0, 0.01 * c, 0.0, 0.02 * c, 0.0, -0.5 * c], jnp.float32))
        Rs.append(np.asarray(R))
        ts.append(np.asarray(t))
    Rs, ts = np.stack(Rs), np.stack(ts)
    f_pt = np.zeros((n_cams, n_feat), np.int32)
    f_uv = np.zeros((n_cams, n_feat, 2), np.float32)
    f_ur = np.full((n_cams, n_feat), -1.0, np.float32)
    f_valid = np.zeros((n_cams, n_feat), bool)
    for c in range(n_cams):
        Xc = P @ Rs[c].T + ts[c]
        uv = np.asarray(cameras.pinhole_project(pin, jnp.asarray(Xc)))
        vis = np.where((Xc[:, 2] > 1) & (np.abs(uv[:, 0] - 620) < 620)
                       & (np.abs(uv[:, 1] - 188) < 188))[0]
        vis = rng.permutation(vis)[:n_feat]
        k = len(vis)
        f_pt[c, :k] = vis
        f_uv[c, :k] = uv[vis] + rng.normal(0, 0.5, (k, 2))
        f_ur[c, :k] = uv[vis, 0] - bf / Xc[vis, 2] + rng.normal(0, 0.5, k)
        f_valid[c, :k] = True
    cam_opt = np.arange(n_cams) >= n_cams // 3
    Rp, tp = Rs.copy(), ts.copy()
    for c in np.where(cam_opt)[0]:
        dR, dt = lie.se3_exp(jnp.asarray(rng.normal(0, 0.01, 6), jnp.float32))
        Rp[c] = np.asarray(dR) @ Rs[c]
        tp[c] = np.asarray(dR) @ ts[c] + np.asarray(dt)
    Pp = (P + rng.normal(0, 0.1, P.shape)).astype(np.float32)
    f_cam = np.repeat(np.arange(n_cams, dtype=np.int32), n_feat)
    F = n_cams * n_feat
    return (np.asarray(pin, np.float32), np.float32(bf), Rp, tp, cam_opt, Pp,
            np.ones(n_pts, bool), f_cam, f_pt.reshape(F),
            f_uv.reshape(F, 2), f_ur.reshape(F), np.ones(F, np.float32),
            f_valid.reshape(F))


def ba_parity(dev, ref_dev, n_cams: int = 12, n_feat: int = 2048,
              n_pts: int = 8192, seed: int = 0, t_tol: float = 1e-4,
              r_tol: float = 1e-5, p_tol: float = 1e-4) -> dict:
    """Camera-blocked ba_solve (the window BA path) on a window of the
    deployment's size: camera translation within `t_tol` m, rotation within
    `r_tol` rad, median point-position relative error within `p_tol`."""
    args = ba_window(n_cams, n_feat, n_pts, seed)
    fn = jax.jit(partial(ba.ba_solve, cameras.PINHOLE, n_iters=10,
                         cam_blocked=True))
    r_dev = _on(dev, fn, *args)
    r_ref = _on(ref_dev, fn, *args)
    dR = np.einsum("cij,ckj->cik", r_dev.kf_R.astype(np.float64),
                   r_ref.kf_R.astype(np.float64))
    # small-angle rotation difference from the skew part (arccos of the
    # trace cannot resolve angles below ~1e-3 rad in f32-orthonormal input)
    skew = 0.5 * np.stack([dR[:, 2, 1] - dR[:, 1, 2], dR[:, 0, 2] - dR[:, 2, 0],
                           dR[:, 1, 0] - dR[:, 0, 1]], axis=1)
    ang = np.arcsin(np.clip(np.linalg.norm(skew, axis=1), 0, 1))
    rel = (np.linalg.norm(r_dev.mp_pos - r_ref.mp_pos, axis=1)
           / np.maximum(np.linalg.norm(r_ref.mp_pos, axis=1), 1e-9))
    out = {"cams": n_cams, "factors": n_cams * n_feat, "points": n_pts,
           "max_dt_m": float(np.abs(r_dev.kf_t - r_ref.kf_t).max()),
           "max_drot_rad": float(ang.max()),
           "median_point_rel": float(np.median(rel)),
           "inliers": [int(r_dev.f_inlier.sum()), int(r_ref.f_inlier.sum())]}
    _require(min(out["inliers"]) >= 0.8 * args[-1].sum(), out)
    _require(out["max_dt_m"] <= t_tol, out)
    _require(out["max_drot_rad"] <= r_tol, out)
    _require(out["median_point_rel"] <= p_tol, out)
    return out
