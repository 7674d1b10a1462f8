"""Sliding-window map sparsification stage — the MS-SLAM novelty.

Host orchestration mirroring MapSparsification::Run
(/root/reference/src/MapSparsification.cc:23-): keyframes that leave the
local-mapping window for `nonlocal_kf` consecutive iterations are queued
(ref KeyFrame::UpdateCountInLocalMapping, src/KeyFrame.cc:980, and the feed
at src/LocalMapping.cc:252-274); once enough are queued, a window of them is
solved by the batched selector (ops/select.py, replacing the GUROBI ILP) and the
unselected points are deleted from the map. Surviving keyframes are marked
sparsified, their feature arrays are compacted (the EraseBadDescriptor
analog, src/KeyFrame.cc:311-361) and handed to loop closing so that place
recognition only ever sees sparsified keyframes
(src/LoopClosing.cc:318-326).
"""
from __future__ import annotations

import os
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models import map_state as M
from ..ops import select


class SparsifyOut(NamedTuple):
    ms: M.MapState
    n_kept: jnp.ndarray
    n_killed: jnp.ndarray
    n_slots_freed: jnp.ndarray   # feature slots compacted away (exact,
    #   for the measured-memory accounting)


@partial(jax.jit, static_argnames=("grid_w", "grid_h", "img_w", "img_h",
                                   "pt_cap", "n_outkf"))
def build_window_tables(ms: M.MapState, win_idx: jnp.ndarray,
                        win_mask: jnp.ndarray, n_req: jnp.ndarray,
                        grid_w: int, grid_h: int, img_w: int, img_h: int,
                        pt_cap: int, n_outkf: int):
    """Assemble one window's selection instance: observation table rows
    for the window keyframes plus pro-rated out-of-window observers (ref
    MapSparsification.cc:61-151). Returns (obs_pt, obs_cell, obs_ok,
    cost, pt_idx, pt_valid, req)."""
    Mc = ms.mp_pos.shape[0]
    Kc, N = ms.obs_mp.shape
    n_cells = grid_w * grid_h
    # culled keyframes may still sit in the host queue; drop them here
    win_mask = win_mask & ms.kf_valid[win_idx]

    # dense point set of the window
    pmask = M.local_map_mask(ms, win_idx, win_mask)
    pt_idx, pt_valid = M.gather_local_points(ms, pmask, pt_cap)
    inv = jnp.full((Mc + 1,), -1, jnp.int32).at[
        jnp.where(pt_valid, pt_idx, Mc)].set(
        jnp.arange(pt_cap, dtype=jnp.int32), mode="drop")

    # window observation rows
    obs_w = ms.obs_mp[win_idx]                                  # (Ws,N)
    pt_w = inv[jnp.clip(obs_w, 0, Mc)]
    ok_w = (obs_w >= 0) & (pt_w >= 0) & win_mask[:, None]
    xy = ms.kp_xy[win_idx]
    cx = jnp.clip((xy[..., 0] * grid_w / img_w).astype(jnp.int32),
                  0, grid_w - 1)
    cy = jnp.clip((xy[..., 1] * grid_h / img_h).astype(jnp.int32),
                  0, grid_h - 1)
    cell_w = cy * grid_w + cx

    # out-of-window observers of window points (pro-rated coverage)
    in_win = jnp.zeros((Kc,), bool).at[
        jnp.where(win_mask, win_idx, Kc)].set(True, mode="drop")
    obs_all_dense = inv[jnp.clip(ms.obs_mp, 0, Mc)]
    sees_win = (ms.obs_mp >= 0) & (obs_all_dense >= 0)
    votes = jnp.sum(sees_win, axis=1) * ms.kf_valid * (~in_win)
    votes_out, out_idx = jax.lax.top_k(votes, n_outkf)
    out_mask = votes_out > 0
    obs_o = ms.obs_mp[out_idx]
    pt_o = inv[jnp.clip(obs_o, 0, Mc)]
    ok_o = (obs_o >= 0) & (pt_o >= 0) & out_mask[:, None]
    n_total_o = jnp.sum(ms.obs_mp[out_idx] >= 0, axis=1)
    ratio = votes_out / jnp.maximum(n_total_o, 1)
    req_o = jnp.ceil(ratio * n_req).astype(jnp.int32) * out_mask
    cell_o = jnp.full_like(obs_o, n_cells)      # no grid constraint

    obs_pt = jnp.concatenate([pt_w, pt_o], axis=0)
    obs_cell = jnp.concatenate([cell_w, cell_o], axis=0)
    obs_ok = jnp.concatenate([ok_w, ok_o], axis=0)
    req = jnp.concatenate(
        [jnp.where(win_mask, n_req, 0).astype(jnp.int32), req_o])

    # cost = maxObs - obs(p) over the window's point set
    n_obs_all = M.mp_obs_count(ms)
    obs_count = jnp.where(pt_valid, n_obs_all[pt_idx], 0)
    max_obs = jnp.max(obs_count)
    cost = (max_obs - obs_count).astype(jnp.float32)
    return obs_pt, obs_cell, obs_ok, cost, pt_idx, pt_valid, req


@partial(jax.jit, static_argnames=("grid_w", "grid_h", "img_w", "img_h",
                                   "pt_cap", "n_outkf"))
def sparsify_window(ms: M.MapState, win_idx: jnp.ndarray,
                    win_mask: jnp.ndarray,
                    n_req: jnp.ndarray, lam: jnp.ndarray,
                    lam_grid: jnp.ndarray,
                    grid_w: int, grid_h: int, img_w: int, img_h: int,
                    pt_cap: int, n_outkf: int) -> SparsifyOut:
    """Run the selector over one keyframe window and apply the result.

    Builds the observation table (window rows + pro-rated out-of-window
    observer rows, ref MapSparsification.cc:125-151), solves, deletes
    unselected points, marks + compacts the window keyframes.
    """
    Mc = ms.mp_pos.shape[0]
    Kc, N = ms.obs_mp.shape
    n_cells = grid_w * grid_h
    win_mask = win_mask & ms.kf_valid[win_idx]
    (obs_pt, obs_cell, obs_ok, cost, pt_idx, pt_valid,
     req) = build_window_tables(ms, win_idx, win_mask, n_req,
                                grid_w, grid_h, img_w, img_h,
                                pt_cap, n_outkf)

    res = select.select_points(obs_pt, obs_cell, obs_ok, cost, pt_valid,
                               req, lam=lam, lam_grid=lam_grid,
                               n_cells=n_cells)

    # delete unselected, mark kept as sparsified
    kill_local = pt_valid & ~res.keep
    kill = jnp.zeros((Mc,), bool).at[
        jnp.where(kill_local, pt_idx, Mc)].set(True, mode="drop")
    ms = M.delete_map_points(ms, kill)
    keep_slots = jnp.where(pt_valid & res.keep, pt_idx, Mc)
    ms = ms._replace(
        mp_sparsified=ms.mp_sparsified.at[keep_slots].set(True, mode="drop"))

    # mark + compact window keyframes (EraseBadDescriptor analog: only
    # surviving observations keep live feature slots)
    wslots = jnp.where(win_mask, win_idx, Kc)
    ms = ms._replace(
        kf_sparsified=ms.kf_sparsified.at[wslots].set(True, mode="drop"))
    old_kp_valid = ms.kp_valid[win_idx] & win_mask[:, None]
    new_kp_valid = ms.kp_valid[win_idx] & (ms.obs_mp[win_idx] >= 0)
    n_slots_freed = jnp.sum(
        old_kp_valid & ~(new_kp_valid & win_mask[:, None]))
    ms = ms._replace(
        kp_valid=ms.kp_valid.at[wslots].set(new_kp_valid, mode="drop"))
    return SparsifyOut(ms=ms,
                       n_kept=jnp.sum(pt_valid & res.keep).astype(jnp.int32),
                       n_killed=jnp.sum(kill).astype(jnp.int32),
                       n_slots_freed=n_slots_freed.astype(jnp.int32))


class Sparsifier:
    """Host-side stage state (the MapSparsification 'thread')."""

    def __init__(self, system):
        self.sys = system
        cfg = system.cfg
        self.nonlocal_kf = cfg.nonlocal_kf
        self.window = cfg.sparsify_window
        self.queue_min = cfg.sparsify_queue_min
        self.n_req = cfg.sparsify_n
        self.lam = cfg.sparsify_lambda
        self.lam_grid = cfg.sparsify_grid_lambda
        self.miss: dict[int, int] = {}
        self.queue: list[int] = []
        self.done: set[int] = set()
        self._pending_counts: list = []
        self._stats = {"windows": 0, "killed": 0, "kept": 0,
                       "slots_freed": 0}

    @property
    def stats(self) -> dict:
        """Counters; drains any asynchronously-riding window counts."""
        while self._pending_counts:
            nk, nkept, nsl = self._pending_counts.pop(0)
            self._stats["killed"] += int(nk)
            self._stats["kept"] += int(nkept)
            self._stats["slots_freed"] += int(nsl)
        return self._stats

    def forget(self, slot: int):
        """Drop bookkeeping for a culled/recycled keyframe slot."""
        self.done.discard(slot)
        self.miss.pop(slot, None)
        if slot in self.queue:
            self.queue.remove(slot)

    def observe_window(self, window_slots: list[int]):
        """Called after each local-mapping iteration with the BA window
        (ref UpdateCountInLocalMapping: consecutive misses make a KF
        non-local and feed it to sparsification). The window here is the
        covisibility neighborhood of the newest keyframe, which is also
        tracking's local-keyframe set — so in IMU mode (where the
        reference feeds from Tracking-side miss counters instead, ref
        KeyFrame::UpdateCountInTracking via src/Tracking.cc:3615-3636,
        because the inertial LBA window is temporal) the same counters
        implement the tracking-side feed."""
        win = set(window_slots)
        free = set(self.sys.kf_free)
        for k in range(self.sys.n_kf):
            if k in self.done or k in self.queue or k in free:
                continue
            if k in win:
                self.miss[k] = 0
            else:
                self.miss[k] = self.miss.get(k, 0) + 1
                if self.miss[k] >= self.nonlocal_kf:
                    self.queue.append(k)
        self.maybe_sparsify()

    def inertial_ready(self) -> bool:
        """Inertial gate (ref MapSparsification::CheckNewKeyFrames,
        src/MapSparsification.cc:197-198: in IMU mode no window is solved
        until the map's inertial BA2 flag is set — sparsifying before
        gravity/scale have converged would delete points the inertial
        refinement still needs). Stage >= 2 is the VIBA-refined state."""
        sys = self.sys
        if not getattr(sys.cfg, "use_imu", False):
            return True
        return (getattr(sys, "imu_initialized", False)
                and getattr(sys, "_imu_stage", 0) >= 2)

    def maybe_sparsify(self, force: bool = False):
        if not force and not self.inertial_ready():
            return
        while len(self.queue) >= (1 if force else self.queue_min):
            batch = self.queue[:self.window]
            if not batch:
                break
            self.queue = self.queue[len(batch):]
            self._sparsify(batch)
            if not force:
                break

    def _sparsify(self, batch: list[int]):
        sys = self.sys
        Ws = self.window
        win_idx = np.full(Ws, 0, np.int32)
        win_mask = np.zeros(Ws, bool)
        win_idx[:len(batch)] = batch
        win_mask[:len(batch)] = True
        dump_dir = os.environ.get("MSSLAM_DUMP_WINDOWS")
        if dump_dir:
            # diagnostic: persist the exact selection instance this window
            # solves, for offline comparison against the exact ILP
            tabs = build_window_tables(
                sys.ms, jnp.asarray(win_idx), jnp.asarray(win_mask),
                jnp.asarray(self.n_req),
                grid_w=sys.cfg.map.grid_w, grid_h=sys.cfg.map.grid_h,
                img_w=sys.calib.width, img_h=sys.calib.height,
                pt_cap=sys.cfg.map.local_mp_cap * 2, n_outkf=8)
            names = ("obs_pt", "obs_cell", "obs_ok", "cost", "pt_idx",
                     "pt_valid", "req")
            os.makedirs(dump_dir, exist_ok=True)
            np.savez(os.path.join(
                dump_dir, f"window_{self._stats['windows']:03d}.npz"),
                **{k: np.asarray(v) for k, v in zip(names, tabs)},
                lam=self.lam, lam_grid=self.lam_grid,
                n_cells=sys.cfg.map.grid_w * sys.cfg.map.grid_h)
        out = sparsify_window(
            sys.ms, jnp.asarray(win_idx), jnp.asarray(win_mask),
            jnp.asarray(self.n_req), jnp.asarray(self.lam, jnp.float32),
            jnp.asarray(self.lam_grid, jnp.float32),
            grid_w=sys.cfg.map.grid_w, grid_h=sys.cfg.map.grid_h,
            img_w=sys.calib.width, img_h=sys.calib.height,
            pt_cap=sys.cfg.map.local_mp_cap * 2,
            n_outkf=8)
        sys.ms = out.ms
        sys._obs_dirty = True
        self.done.update(batch)
        self.stats["windows"] += 1
        # the counters ride back asynchronously — a synchronous int() here
        # would stall the camera-rate path on a full device round trip
        # (the reference's sparsifier thread never blocks tracking either)
        for h in (out.n_killed, out.n_kept, out.n_slots_freed):
            try:
                h.copy_to_host_async()
            except Exception:
                pass
        self._pending_counts.append(
            (out.n_killed, out.n_kept, out.n_slots_freed))
        # sparsified keyframes enter the shared place-recognition database
        # (ref LoopClosing::DeleteOutdatedInfo -> KeyFrameDatabase::add,
        # src/LoopClosing.cc:318-326); reloc uses it even without a loop
        # closer
        if sys.kf_db is not None:
            for k in batch:
                sys.kf_db.add(k, sys.ms.kp_desc[k], sys.ms.kp_valid[k])

    def finish(self):
        """Sparsify everything left (ref MapSparsification.cc:38-52 on
        RequestFinish)."""
        free = set(self.sys.kf_free)
        for k in range(self.sys.n_kf):
            if k not in self.done and k not in self.queue and k not in free:
                self.queue.append(k)
        self.maybe_sparsify(force=True)
