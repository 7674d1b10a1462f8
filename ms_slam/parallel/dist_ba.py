"""Distributed bundle adjustment over a device mesh.

No reference counterpart exists — MS-SLAM is single-process
(/root/reference SURVEY §2.7) — this is the scale-out path (SURVEY §7
Phase 5).

Sharding design (v2 — scales to production pool shapes):

- The factor table is routed host-side so that every observation of a map
  point lands on the device that OWNS that point (point-range ownership:
  device d owns points [d*Pp, (d+1)*Pp)). Jacobian work is ~1/D, and the
  per-point Hessian blocks Hpp/bp need NO collective — all contributions
  are local.
- The reduced camera system is solved matrix-free: S = Hcc - Wᵀ Hpp⁻¹ W is
  never materialized (the old implementation psummed a dense (P, C, 6, 3)
  coupling tensor — ~2.4 GB at max_kf=512/max_mp=65536). Instead a
  preconditioned CG runs on the (C*6,) camera system; each matvec is two
  per-factor einsum+scatter passes and ONE psum collective of a (C*6,)
  vector. Per-iteration communication is O(C*6), per-device memory O(F/D + P).
- Cameras (tiny) stay replicated; point updates are computed locally and
  all_gathered.

One jit, no host involvement per iteration.
"""
from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import lie, robust
from ..ops.ba import _factor_res_jac


def make_mesh(n_devices: int | None = None, axis: str = "factors") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def shard_factors(mesh: Mesh, *arrays, axis: str = "factors"):
    """Place factor-table arrays with their leading dim split over the mesh."""
    sh = NamedSharding(mesh, P(axis))
    return tuple(jax.device_put(a, sh) for a in arrays)


def replicate(mesh: Mesh, *arrays):
    sh = NamedSharding(mesh, P())
    return tuple(jax.device_put(a, sh) for a in arrays)


def route_factors_by_point(n_devices: int, Pn: int, f_pt, f_valid,
                           *arrays):
    """Host-side routing: reorder factor rows so device d receives exactly
    the factors of its owned point range [d*Pp, (d+1)*Pp), padded to a
    common per-device capacity. Invalid rows are spread round-robin (they
    carry zero weight). Returns (Pp, routed_f_pt, routed_f_valid,
    *routed_arrays), each with leading dim D * F_cap."""
    D = n_devices
    Pp = -(-Pn // D)
    f_pt = np.asarray(f_pt)
    f_valid = np.asarray(f_valid)
    F = f_pt.shape[0]
    shard = np.where(f_valid, f_pt // Pp, np.arange(F) % D).astype(np.int64)
    counts = np.bincount(shard, minlength=D)
    F_cap = max(int(counts.max()), 1)
    order = np.argsort(shard, kind="stable")
    starts = np.zeros(D, np.int64)
    starts[1:] = np.cumsum(counts)[:-1]
    # position of each (sorted) row inside its device block
    pos_in_shard = np.arange(F) - starts[shard[order]]
    dst = shard[order] * F_cap + pos_in_shard
    idx = np.full(D * F_cap, -1, np.int64)
    idx[dst] = order
    pad = idx < 0
    gi = np.where(pad, 0, idx)
    routed_pt = np.where(pad, 0, f_pt[gi]).astype(np.int32)
    routed_valid = np.where(pad, False, f_valid[gi])
    routed = [np.asarray(a)[gi] for a in arrays]
    return Pp, routed_pt, routed_valid, routed


def dist_ba_solve(mesh: Mesh, model: int, params, bf,
                  kf_R, kf_t, cam_opt, mp_pos, pt_opt,
                  f_cam, f_pt, f_uv, f_ur, f_sigma2, f_valid,
                  n_iters: int = 10, lam: float = 1e-4,
                  axis: str = "factors", n_cg: int | None = None):
    """Sharded ba_solve: same semantics as ops.ba.ba_solve's iteration (no
    two-stage outlier schedule), factors routed by point ownership and the
    reduced camera system solved by preconditioned CG.
    Returns (kf_R, kf_t, mp_pos)."""
    C = kf_R.shape[0]
    Pn = mp_pos.shape[0]
    dt = jnp.asarray(kf_R).dtype
    params = jnp.asarray(params, dt)
    bf = jnp.asarray(bf, dt)
    D = mesh.devices.size
    if n_cg is None:
        # scale the CG budget with the camera-system size: large post-loop
        # global BAs (C*6 in the thousands) under-converge on a fixed small
        # cap (ADVICE r3)
        n_cg = min(C * 6, max(96, (C * 6) // 8))

    Pp, f_pt_r, f_valid_r, (f_cam_r, f_uv_r, f_ur_r, f_s2_r) = \
        route_factors_by_point(D, Pn, f_pt, f_valid,
                               f_cam, f_uv, f_ur, f_sigma2)
    f_cam_r, f_pt_r, f_uv_r, f_ur_r, f_s2_r, f_valid_r = shard_factors(
        mesh, f_cam_r, f_pt_r, jnp.asarray(f_uv_r, dt),
        jnp.asarray(f_ur_r, dt), jnp.asarray(f_s2_r, dt), f_valid_r,
        axis=axis)

    fspec = P(axis)
    rspec = P()

    @partial(jax.jit, static_argnames=())
    @partial(jax.shard_map, mesh=mesh,
             in_specs=(rspec, rspec, rspec, rspec, rspec,
                       fspec, fspec, fspec, fspec, fspec, fspec),
             out_specs=rspec)
    def run(kf_R, kf_t, cam_opt, mp_pos, pt_opt,
            f_cam, f_pt, f_uv, f_ur, f_sigma2, f_valid):
        d = jax.lax.axis_index(axis)
        p_lo = d * Pp
        # local point index of each factor (all factors of an owned point
        # are local by construction; zero-weight rows may fall anywhere)
        f_ptl = jnp.clip(f_pt - p_lo, 0, Pp - 1)
        pt_opt_l = jax.lax.dynamic_slice_in_dim(
            jnp.pad(pt_opt, (0, D * Pp - Pn)), p_lo, Pp)
        is_stereo = f_ur >= 0.0
        w_info = jnp.where(f_valid, 1.0 / jnp.maximum(f_sigma2, 1e-12), 0.0)
        hub_d2 = jnp.where(is_stereo, robust.CHI2_3DOF, robust.CHI2_2DOF)

        def iteration(state, _):
            R_all, t_all, P_rep = state
            res, Jc, Jp, z = _factor_res_jac(
                model, params, bf, R_all, t_all, P_rep,
                f_cam, f_pt, f_uv, f_ur, is_stereo)
            chi2 = jnp.sum(res * res, axis=-1) * w_info
            active = z > 1e-2
            w = robust.huber_weight(chi2, hub_d2) * w_info * active
            Jc = jnp.where(cam_opt[f_cam][:, None, None], Jc, 0.0)
            Jp = jnp.where(pt_opt_l[f_ptl][:, None, None], Jp, 0.0)
            sw = jnp.sqrt(w)[:, None, None]
            Jc = Jc * sw          # whitened Jacobians: H = JᵀJ exactly
            Jp = Jp * sw
            rw = res * jnp.sqrt(w)[:, None]

            # camera blocks: psum (C is small)
            Hcc = jax.lax.psum(
                jnp.zeros((C, 6, 6), dt).at[f_cam].add(
                    jnp.einsum("fij,fik->fjk", Jc, Jc)), axis)
            bc = jax.lax.psum(
                jnp.zeros((C, 6), dt).at[f_cam].add(
                    -jnp.einsum("fij,fi->fj", Jc, rw)), axis)
            # point blocks: LOCAL (point-owned routing)
            Hpp = jnp.zeros((Pp, 3, 3), dt).at[f_ptl].add(
                jnp.einsum("fij,fik->fjk", Jp, Jp))
            bp = jnp.zeros((Pp, 3), dt).at[f_ptl].add(
                -jnp.einsum("fij,fi->fj", Jp, rw))

            eyeC = jnp.eye(6, dtype=dt)
            Hcc = Hcc + lam * jax.vmap(
                lambda h: jnp.diag(jnp.diag(h)))(Hcc) + 1e-8 * eyeC
            eyeP = jnp.eye(3, dtype=dt)
            Hpp = Hpp + lam * jax.vmap(
                lambda h: jnp.diag(jnp.diag(h)))(Hpp) + 1e-8 * eyeP
            Hpp_inv = lie.inv3x3(Hpp)

            def W_apply(xc):
                """(W x)_p = sum_f Jpᵀ (Jc x_cam): (C,6)->(Pp,3), local."""
                u = jnp.einsum("fij,fj->fi", Jc, xc[f_cam])     # (F,3)
                return jnp.zeros((Pp, 3), dt).at[f_ptl].add(
                    jnp.einsum("fij,fi->fj", Jp, u))

            def Wt_apply(zp):
                """(Wᵀ z)_c = sum_f Jcᵀ (Jp z_pt): (Pp,3)->(C,6), psum."""
                u = jnp.einsum("fij,fj->fi", Jp, zp[f_ptl])     # (F,3)
                return jax.lax.psum(
                    jnp.zeros((C, 6), dt).at[f_cam].add(
                        jnp.einsum("fij,fi->fj", Jc, u)), axis)

            def S_apply(xc):
                hx = jnp.einsum("cij,cj->ci", Hcc, xc)
                zp = jnp.einsum("pxy,py->px", Hpp_inv, W_apply(xc))
                return hx - Wt_apply(zp) + 1e-8 * xc

            # RHS: v = bc - Wᵀ Hpp⁻¹ bp
            v = bc - Wt_apply(jnp.einsum("pxy,py->px", Hpp_inv, bp))

            # preconditioned CG on the (C,6) camera system; M = Hcc blocks
            Hcc_pinv = jnp.linalg.inv(Hcc)

            def prec(r):
                return jnp.einsum("cij,cj->ci", Hcc_pinv, r)

            # fixed-length CG with breakdown/convergence freezing: once the
            # preconditioned residual has dropped to float precision (or the
            # curvature goes non-positive), further iterations only amplify
            # rounding noise — freeze the iterate instead
            rel_stop = jnp.asarray(jnp.finfo(dt).eps, dt) ** 2

            def cg_step(carry, _):
                x, r, p, rz, rz0, ok = carry
                Sp = S_apply(p)
                denom = jnp.sum(p * Sp)
                ok = ok & (denom > 0) & (rz > rel_stop * rz0)
                alpha = jnp.where(ok, rz / jnp.where(denom > 0, denom, 1.0),
                                  0.0)
                x = x + alpha * p
                r = r - alpha * Sp
                zn = prec(r)
                rz_new = jnp.where(ok, jnp.sum(r * zn), rz)
                ok = ok & (rz_new > 0)
                beta = jnp.where(ok, rz_new
                                 / jnp.where(rz > 0, rz, 1.0), 0.0)
                p = jnp.where(ok, zn + beta * p, p)
                return (x, r, p, rz_new, rz0, ok), None

            x0 = jnp.zeros((C, 6), dt)
            z0 = prec(v)
            rz0 = jnp.sum(v * z0)
            (dxc, _, _, rz_f, _, _), _ = jax.lax.scan(
                cg_step, (x0, v, z0, rz0, rz0, rz0 > 0), None, length=n_cg)
            cg_ratio = jnp.sqrt(jnp.maximum(rz_f, 0.0)
                                / jnp.maximum(rz0, 1e-30))

            # point back-substitution (local), re-assembled with a psum
            # (each device contributes only its owned point range)
            dxp_l = jnp.einsum("pxy,py->px", Hpp_inv, bp - W_apply(dxc))
            dxp_l = dxp_l * pt_opt_l[:, None]
            dxp = jax.lax.psum(
                jax.lax.dynamic_update_slice_in_dim(
                    jnp.zeros((D * Pp, 3), dt), dxp_l, p_lo, 0),
                axis)[:Pn]

            dxc = dxc * cam_opt[:, None]
            dR, dtc = lie.se3_exp(dxc)
            R_new, t_new = lie.se3_compose(dR, dtc, R_all, t_all)
            R_new = lie.normalize_rotation(R_new)
            return (R_new, t_new, P_rep + dxp), cg_ratio

        state, ratios = jax.lax.scan(iteration, (kf_R, kf_t, mp_pos), None,
                                     length=n_iters)
        return state + (ratios,)

    kf_R, kf_t, cam_opt, mp_pos, pt_opt = replicate(
        mesh, jnp.asarray(kf_R), jnp.asarray(kf_t), jnp.asarray(cam_opt),
        jnp.asarray(mp_pos), jnp.asarray(pt_opt))
    R_n, t_n, P_n, cg_ratios = run(
        kf_R, kf_t, cam_opt, mp_pos, pt_opt,
        f_cam_r, f_pt_r, f_uv_r, f_ur_r, f_s2_r, f_valid_r)
    return R_n, t_n, P_n, cg_ratios


def dist_global_ba(ms, calib, orb_cfg, fixed_kf: int, mesh: Mesh,
                   n_iters: int = 10, axis: str = "factors"):
    """Whole-map global BA through the device mesh — the pipeline entry
    point (ref Optimizer::GlobalBundleAdjustemnt via
    RunGlobalBundleAdjustment, src/LoopClosing.cc:2212, here sharded over
    the device mesh instead of a transient host thread). Builds the same full factor
    table as pipeline.mapping_ops.global_ba and runs the sharded Schur-CG
    solver; returns the updated MapState."""
    from ..pipeline.mapping_ops import _scale2

    K, N = ms.obs_mp.shape
    obs = ms.obs_mp
    f_valid = (obs >= 0) & ms.kf_valid[:, None] & ms.kp_valid
    f_cam = jnp.broadcast_to(
        jnp.arange(K, dtype=jnp.int32)[:, None], (K, N)).reshape(-1)
    f_pt = jnp.clip(obs, 0).reshape(-1)
    f_uv = ms.kp_xy.reshape(K * N, 2)
    f_ur = ms.kp_uright.reshape(-1)
    s2 = _scale2(orb_cfg)
    f_s2 = s2[ms.kp_octave].reshape(-1)
    f_valid = f_valid.reshape(-1)
    cam_opt = ms.kf_valid & (jnp.arange(K) != fixed_kf)

    R_n, t_n, P_n, cg_ratios = dist_ba_solve(
        mesh, calib.model, calib.params_array(), jnp.asarray(calib.bf),
        ms.kf_R, ms.kf_t, cam_opt, ms.mp_pos, ms.mp_valid,
        f_cam, f_pt, f_uv, f_ur, f_s2, f_valid, n_iters=n_iters)
    # surface the final preconditioned CG residual ratio so an
    # under-converged reduced-camera solve is detectable (ADVICE r3)
    last = float(jax.device_get(cg_ratios[-1]))
    if last > 1e-2:
        print(f"# dist_global_ba: CG residual ratio {last:.3e} "
              f"(under-converged reduced camera solve)")
    return ms._replace(kf_R=R_n, kf_t=t_n, mp_pos=P_n)
