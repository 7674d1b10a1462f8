"""Sliding-window map-point selection: the MS-SLAM sparsification ILP,
as batched device code.

Reference formulation (MapSparsification::Sparsifying,
/root/reference/src/MapSparsification.cc:58-171, GUROBI, MIPGap 0.002):
binary x_p per map point observed in a window of keyframes;

  min  sum_p (maxObs - obs_p) x_p  +  lambda * sum_k th_k
                                   +  lambda_grid * sum_cell th_cell
  s.t. per window KF k:        sum_{p in KF k} x_p + th_k     >= N
       per occupied grid cell: sum_{p in cell} x_p + th_cell  >= 1
       per out-of-window KF o observing window points (pro-rated,
       MapSparsification.cc:125-151):
                               sum_{p in o} x_p + th_o >= ceil(ratio_o * N)

Crucially BOTH constraint families are slack-priced, not hard: the ILP
freely pays lambda_grid (=10) to leave a cell uncovered whenever every
covering point would cost more, and pays lambda per unit of keyframe
shortfall (lambda=500 >> point costs makes the KF constraints effectively
hard in practice, but the cell constraints bind only for cheap points).

Formulation, three stages, all batched scatter/gather over the
observation table (no constraint matrix is ever materialized):

1. LP relaxation by projected dual ascent. Every constraint is a sum over
   observations (each observation belongs to exactly one KF row and one
   grid cell), so one iteration is two scatter/gather passes:

     score_p = sum_{obs of p} (y_kf(obs) + y_cell(obs));  x_p = [score > cost]
     y_c    <- clip(y_c + eta_t * viol_c, 0, price_c)

   Optimal duals live at the scale of the POINT COSTS divided by the
   observation multiplicity — not at the slack price lambda — so step
   sizes derive from max(cost) and keyframe violations are normalized by
   their requirement. Iterates oscillate around the optimum; the duals
   used for rounding are the running average of the second half.

2. Feasibility repair: per-KF top-up to the requirement (LP-selected
   observations first, then cheapest points), then PRICE-AWARE cell
   repair — a still-uncovered occupied cell is covered by its cheapest
   observation only when that point costs less than lambda_grid (the
   ILP's own trade-off); otherwise the slack is paid, exactly as the
   reference solver does.

3. Batched safe-prune to near-optimality: the union repair overshoots,
   so iterate rounds that drop every point whose cost exceeds its
   marginal penalty, subject to joint-safety caps — per keyframe row at
   most `slack` observations drop per round (ranked by gain), and per
   priced cell at most one non-sole cover drops per round (a sole cover
   may drop when its gain already pays the lambda_grid slack). Each
   round is O(K*N) vectorized work; unlike a scalar greedy loop this
   scales to reference windows (K~38 rows, N=2048, thousands of points).

Selection quality vs the exact ILP (scipy HiGHS stands in for GUROBI) is
asserted in tests, including a full reference-scale instance.

Input layout (static shapes): the window's observation table
  obs_pt   (K, N) int32   dense point slot (0..P-1) or -1
  obs_cell (K, N) int32   grid cell id of the feature (0..G-1); rows whose
                          cells carry no coverage constraint (out-of-window
                          observers) pass obs_cell >= n_cells
plus a per-row requirement vector (N for window rows, ceil(ratio*N) for
out-of-window rows, 0 for padding).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp


class SelectResult(NamedTuple):
    keep: jnp.ndarray        # (P,) bool selected points
    lp_keep: jnp.ndarray     # (P,) bool LP-rounded selection (pre-repair)
    kf_cover: jnp.ndarray    # (K,) final per-KF kept-observation counts


@partial(jax.jit, static_argnames=("n_cells", "n_iters", "n_rounds"))
def select_points(
    obs_pt: jnp.ndarray, obs_cell: jnp.ndarray, obs_valid: jnp.ndarray,
    cost: jnp.ndarray, p_valid: jnp.ndarray,
    req_kf: jnp.ndarray,
    lam: float | jnp.ndarray = 500.0,
    lam_grid: float | jnp.ndarray = 10.0,
    n_cells: int = 64 * 48,
    n_iters: int = 60,
    n_rounds: int = 24,
) -> SelectResult:
    """Solve the selection problem.

    Args:
      obs_pt:   (K,N) dense point ids per observation row (-1 invalid). Rows
                may be window KFs or pro-rated out-of-window observers.
      obs_cell: (K,N) cell id per observation (>= n_cells: unconstrained).
      obs_valid:(K,N) bool.
      cost:     (P,) point cost (maxObs - obs count), >= 0.
      p_valid:  (P,) bool.
      req_kf:   (K,) per-row coverage requirement.
    """
    K, N = obs_pt.shape
    P = cost.shape[0]
    obs_ok = obs_valid & (obs_pt >= 0)
    pt = jnp.where(obs_ok, obs_pt, P)            # sentinel -> dropped
    ptc = jnp.clip(obs_pt, 0, P - 1)
    # global cell ids, row-major (kf, cell); sentinel = K*n_cells
    cell_ok = obs_ok & (obs_cell >= 0) & (obs_cell < n_cells)
    G = K * n_cells
    gcell = jnp.where(cell_ok,
                      jnp.arange(K)[:, None] * n_cells + obs_cell,
                      G)

    occupied = jnp.zeros((G + 1,), bool).at[gcell.reshape(-1)].set(
        True).at[-1].set(False)

    lam = jnp.asarray(lam, jnp.float32)
    lam_grid = jnp.asarray(lam_grid, jnp.float32)
    req_f = req_kf.astype(jnp.float32)
    cost_obs = cost[ptc]
    # unique float tie-break keys (costs are typically small integers)
    tiebreak = ptc.astype(jnp.float32) / (P + 2.0)

    # ---- stage 1: dual ascent on the LP relaxation ----
    cmax = jnp.maximum(jnp.max(jnp.where(p_valid, cost, 0.0)), 1.0)

    def score_of(y_kf, y_cell):
        contrib = (y_kf[:, None] + y_cell[gcell]) * obs_ok
        return jnp.zeros((P + 1,), jnp.float32).at[pt.reshape(-1)].add(
            contrib.reshape(-1))[:P]

    half_at = n_iters - n_iters // 2            # averaging window start

    def ascent(carry, t):
        y_kf, y_cell, acc_kf, acc_cell = carry
        score = score_of(y_kf, y_cell)
        x = ((score > cost) & p_valid).astype(jnp.float32)
        xv = x[ptc] * obs_ok
        cover_kf = jnp.sum(xv, axis=1)
        cover_cell = jnp.zeros((G + 1,), jnp.float32).at[
            gcell.reshape(-1)].add(xv.reshape(-1))
        eta = cmax / (2.0 + 0.5 * t)
        y_kf = jnp.clip(
            y_kf + eta * (req_f - cover_kf) / jnp.maximum(req_f, 1.0),
            0.0, lam)
        y_cell = jnp.clip(
            y_cell + eta * (1.0 - cover_cell) * occupied, 0.0, lam_grid)
        in_avg = (t >= half_at).astype(jnp.float32)
        return (y_kf, y_cell,
                acc_kf + y_kf * in_avg, acc_cell + y_cell * in_avg), None

    y0 = (jnp.zeros((K,), jnp.float32), jnp.zeros((G + 1,), jnp.float32),
          jnp.zeros((K,), jnp.float32), jnp.zeros((G + 1,), jnp.float32))
    (_, _, acc_kf, acc_cell), _ = jax.lax.scan(
        ascent, y0, jnp.arange(n_iters, dtype=jnp.float32))
    denom = float(max(n_iters - half_at, 1))
    lp_keep = (score_of(acc_kf / denom, acc_cell / denom) > cost) & p_valid

    # ---- stage 2: feasibility repair ----
    sel_obs = lp_keep[ptc] & obs_ok
    # per-KF top-up to req: LP-selected observations first, then cheap
    prio = jnp.where(obs_ok, sel_obs * 1e6 - cost_obs - tiebreak, -jnp.inf)
    order = jnp.argsort(-prio, axis=1)           # (K,N) best first
    rank = jnp.zeros((K, N), jnp.int32).at[
        jnp.arange(K)[:, None], order].set(
        jnp.broadcast_to(jnp.arange(N, dtype=jnp.int32), (K, N)))
    topup = rank < req_kf[:, None]
    keep_obs0 = (sel_obs | topup) & obs_ok
    # price-aware cell repair (ref MapSparsification.cc:111-116: cell
    # coverage is a lambda_grid-priced slack constraint, NOT hard): cover
    # an uncovered occupied cell only when the cheapest covering point
    # costs less than the slack the ILP would otherwise pay.
    covered0 = jnp.zeros((G + 1,), bool).at[
        jnp.where(keep_obs0 & cell_ok, gcell, G).reshape(-1)].set(True)
    uncov = occupied & ~covered0
    cprio = jnp.where(cell_ok & uncov[gcell], -cost_obs - tiebreak, -jnp.inf)
    cbest = jnp.full((G + 1,), -jnp.inf, jnp.float32).at[
        gcell.reshape(-1)].max(cprio.reshape(-1))
    cell_best = ((cprio == cbest[gcell]) & (cprio > -jnp.inf)
                 & (cost_obs < lam_grid))

    keep_obs = keep_obs0 | cell_best
    keep = jnp.zeros((P + 1,), bool).at[
        jnp.where(keep_obs, pt, P).reshape(-1)].set(True)[:P] & p_valid

    # ---- stage 3: batched safe-prune rounds ----
    def scatter_or_p(mask_obs):
        return jnp.zeros((P + 1,), bool).at[
            jnp.where(mask_obs, pt, P).reshape(-1)].set(True)[:P]

    def prune_round(r, keep):
        kept_obs = keep[ptc] & obs_ok
        cover_kf = jnp.sum(kept_obs, axis=1)
        slack = jnp.maximum(cover_kf - req_kf, 0)               # (K,)
        cell_cover = jnp.zeros((G + 1,), jnp.int32).at[
            jnp.where(kept_obs & cell_ok, gcell, G).reshape(-1)].add(1)
        # gain of dropping p: its cost minus the lambda_grid slack for
        # every priced cell it is the sole cover of
        sole = kept_obs & cell_ok & (cell_cover[gcell] == 1)
        sole_cnt = jnp.zeros((P + 1,), jnp.float32).at[
            jnp.where(sole, pt, P).reshape(-1)].add(1.0)[:P]
        gain = cost - lam_grid * sole_cnt
        # zero-cost points (obs == maxObs) that cover no sole cell are
        # objective-INDIFFERENT to the ILP; drop them when row slack
        # allows — GUROBI's optima leave unneeded variables at 0, and the
        # kept-fraction/memory metric is what sparsification exists for
        cand_p = keep & ((gain > 0) | ((cost <= 0) & (sole_cnt == 0)))
        # a point kept by a row with no slack can never drop this round;
        # excluding it up front keeps it from occupying a rank slot
        veto0 = kept_obs & (slack == 0)[:, None]
        cand_p = cand_p & ~scatter_or_p(veto0)
        cand_obs = cand_p[ptc] & kept_obs
        # per-row cap: rank candidates by gain desc, admit rank < slack —
        # the joint drop then removes at most `slack` observations per row
        gprio = jnp.where(cand_obs, gain[ptc] - tiebreak, -jnp.inf)
        order2 = jnp.argsort(-gprio, axis=1)
        rank2 = jnp.zeros((K, N), jnp.int32).at[
            jnp.arange(K)[:, None], order2].set(
            jnp.broadcast_to(jnp.arange(N, dtype=jnp.int32), (K, N)))
        row_admit = cand_obs & (rank2 < slack[:, None])
        drop_p = cand_p & ~scatter_or_p(cand_obs & ~row_admit)
        # per-cell cap: at most one non-sole cover drops per priced cell
        # per round (sole covers already paid lambda_grid in their gain);
        # later rounds recompute coverage, so deeper redundancy drains
        # one layer per round
        dobs = drop_p[ptc] & kept_obs & cell_ok & (cell_cover[gcell] >= 2)
        dprio = jnp.where(dobs, gain[ptc] - tiebreak, -jnp.inf)
        dbest = jnp.full((G + 1,), -jnp.inf, jnp.float32).at[
            gcell.reshape(-1)].max(dprio.reshape(-1))
        drop_p = drop_p & ~scatter_or_p(dobs & (dprio < dbest[gcell]))
        return keep & ~drop_p

    keep = jax.lax.fori_loop(0, n_rounds, prune_round, keep)

    kept_obs = keep[ptc] & obs_ok
    kf_cover = jnp.sum(kept_obs, axis=1).astype(jnp.int32)
    return SelectResult(keep=keep, lp_keep=lp_keep, kf_cover=kf_cover)


def selection_cost(keep, cost, kf_cover, req_kf, lam, obs_pt=None,
                   obs_cell=None, obs_valid=None, lam_grid=0.0,
                   n_cells=None):
    """Objective value of a selection (for tests): point costs + lambda *
    per-row shortfall (+ lambda_grid * uncovered occupied cells)."""
    c = jnp.sum(jnp.where(keep, cost, 0.0))
    short = jnp.sum(jnp.maximum(req_kf - kf_cover, 0) * lam)
    cell_pen = 0.0
    if obs_pt is not None and lam_grid:
        K, N = obs_pt.shape
        P = cost.shape[0]
        obs_ok = obs_valid & (obs_pt >= 0)
        priced = obs_ok & (obs_cell >= 0) & (obs_cell < n_cells)
        gcell = jnp.where(priced,
                          jnp.arange(K)[:, None] * n_cells + obs_cell,
                          K * n_cells)
        occupied = jnp.zeros((K * n_cells + 1,), bool).at[
            gcell.reshape(-1)].set(True).at[-1].set(False)
        kept = keep[jnp.clip(obs_pt, 0, P - 1)] & priced
        covered = jnp.zeros((K * n_cells + 1,), bool).at[
            jnp.where(kept, gcell, K * n_cells).reshape(-1)].set(True)
        cell_pen = lam_grid * jnp.sum(occupied & ~covered)
    return c + short + cell_pen
