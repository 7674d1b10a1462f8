"""Fixed-capacity structure-of-arrays map state.

Accelerator-side redesign of the reference's pointer-graph map data model
(/root/reference/src/{Map,KeyFrame,MapPoint}.cc — shared_ptr webs guarded by
per-object mutexes). XLA wants static shapes, so all map state lives in
capacity-bounded pools with validity masks:

- KeyFrame pool: poses + per-keyframe feature arrays (the reference's
  Frame/KeyFrame keypoint, descriptor, uRight, depth vectors,
  include/KeyFrame.h) and the observation table obs_mp (feature-slot ->
  map-point index), which IS the observation structure; the reference's
  reverse map MapPoint::mObservations is derived by masked segment ops.
- MapPoint pool: positions, distinctive descriptors, view stats
  (include/MapPoint.h), tracking counters for culling.

"Deletion" is a mask clear (the functional analog of SetBadFlag,
src/MapPoint.cc:227); slot reuse is host-side free-list bookkeeping.
Covisibility (KeyFrame::UpdateConnections / GetBestCovisibilityKeyFrames)
is not stored: it is recomputed on demand from obs_mp with sorted-membership
counting — cheap, always consistent, no locks.

All functions are pure (state in, state out) and jit-compiled; the host
orchestrator (pipeline/) owns allocation cursors.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class MapConfig(NamedTuple):
    """Static capacities (hashable for jit static args)."""

    max_kf: int = 256
    max_mp: int = 16384
    n_feat: int = 512          # feature slots per keyframe
    local_mp_cap: int = 4096   # local-map matching buffer
    window_kf: int = 8         # local BA optimizable keyframes
    factor_cap: int = 8192     # local BA observation factors
    grid_h: int = 48           # sparsification coverage grid (ref Frame 64x48)
    grid_w: int = 64


class MapState(NamedTuple):
    """The whole SLAM map as one pytree of device arrays."""

    # --- keyframe pool ---
    kf_R: jnp.ndarray            # (K,3,3) world->camera rotation (Tcw)
    kf_t: jnp.ndarray            # (K,3)
    kf_valid: jnp.ndarray        # (K,) bool
    kf_sparsified: jnp.ndarray   # (K,) bool   (ref KeyFrame::mbSparsified)
    kf_frame_id: jnp.ndarray     # (K,) int32
    kf_ord: jnp.ndarray          # (K,) int32 creation ordinal of occupant
    kf_miss: jnp.ndarray         # (K,) int32 consecutive non-local count
    # per-keyframe features
    kp_xy: jnp.ndarray           # (K,N,2) float32 undistorted level-0 coords
    kp_octave: jnp.ndarray       # (K,N) int32
    kp_desc: jnp.ndarray         # (K,N,8) uint32
    kp_uright: jnp.ndarray       # (K,N) float32 (-1 mono)
    kp_depth: jnp.ndarray        # (K,N) float32 (-1 unknown)
    kp_angle: jnp.ndarray        # (K,N) float32 keypoint orientation (rad)
    kp_valid: jnp.ndarray        # (K,N) bool
    obs_mp: jnp.ndarray          # (K,N) int32 map-point idx or -1
    # --- map point pool ---
    mp_pos: jnp.ndarray          # (M,3) float32 world position
    mp_desc: jnp.ndarray         # (M,8) uint32 distinctive descriptor
    mp_normal: jnp.ndarray       # (M,3) float32 mean viewing direction
    mp_min_dist: jnp.ndarray     # (M,) float32 scale-invariance range
    mp_max_dist: jnp.ndarray     # (M,)
    mp_angle: jnp.ndarray        # (M,) float32 keypoint orientation at the
    #   creating observation (rad) — drives the rotation-histogram check
    #   in projection matching (ref keypoint angle of mpRefKF's obs)
    mp_valid: jnp.ndarray        # (M,) bool
    mp_sparsified: jnp.ndarray   # (M,) bool (kept by the selector)
    mp_first_kf: jnp.ndarray     # (M,) int32 reference keyframe SLOT
    mp_first_ord: jnp.ndarray    # (M,) int32 keyframe ORDINAL at creation
    #   (slot is for pose re-anchoring; ordinal for culling age — they
    #   diverge once pool slots are recycled)
    mp_visible: jnp.ndarray      # (M,) int32 frustum-visible count
    mp_found: jnp.ndarray        # (M,) int32 tracked-inlier count
    mp_quarantine: jnp.ndarray   # (M,) int32 mapping-steps before a freed
    #   slot may be reused — in-flight frames still hold the dead id for up
    #   to ~2 steps (ABA guard; the reference gets this from shared_ptr
    #   keeping dead MapPoints alive while a Frame references them)


def empty_map(cfg: MapConfig) -> MapState:
    K, M, N = cfg.max_kf, cfg.max_mp, cfg.n_feat
    f32, i32 = jnp.float32, jnp.int32
    return MapState(
        kf_R=jnp.tile(jnp.eye(3, dtype=f32), (K, 1, 1)),
        kf_t=jnp.zeros((K, 3), f32),
        kf_valid=jnp.zeros((K,), bool),
        kf_sparsified=jnp.zeros((K,), bool),
        kf_frame_id=jnp.zeros((K,), i32),
        kf_ord=jnp.zeros((K,), i32),
        kf_miss=jnp.zeros((K,), i32),
        kp_xy=jnp.zeros((K, N, 2), f32),
        kp_octave=jnp.zeros((K, N), i32),
        kp_desc=jnp.zeros((K, N, 8), jnp.uint32),
        kp_uright=jnp.full((K, N), -1.0, f32),
        kp_depth=jnp.full((K, N), -1.0, f32),
        kp_angle=jnp.zeros((K, N), f32),
        kp_valid=jnp.zeros((K, N), bool),
        obs_mp=jnp.full((K, N), -1, i32),
        mp_pos=jnp.zeros((M, 3), f32),
        mp_desc=jnp.zeros((M, 8), jnp.uint32),
        mp_normal=jnp.zeros((M, 3), f32),
        mp_min_dist=jnp.zeros((M,), f32),
        mp_max_dist=jnp.full((M,), 1e9, f32),
        mp_angle=jnp.zeros((M,), f32),
        mp_valid=jnp.zeros((M,), bool),
        mp_sparsified=jnp.zeros((M,), bool),
        mp_first_kf=jnp.zeros((M,), i32),
        mp_first_ord=jnp.zeros((M,), i32),
        mp_visible=jnp.zeros((M,), i32),
        mp_found=jnp.zeros((M,), i32),
        mp_quarantine=jnp.zeros((M,), i32),
    )


# ---------------------------------------------------------------------------
# Observation-derived quantities
# ---------------------------------------------------------------------------

def mp_obs_count(ms: MapState) -> jnp.ndarray:
    """(M,) number of keyframe observations per map point (replaces
    MapPoint::Observations())."""
    M = ms.mp_pos.shape[0]
    obs = jnp.where(ms.kf_valid[:, None], ms.obs_mp, -1).reshape(-1)
    sl = jnp.where(obs >= 0, obs, M)  # sentinel M dropped by the scatter
    return jnp.zeros((M,), jnp.int32).at[sl].add(1, mode="drop")


def observer_mask(ms: MapState) -> jnp.ndarray:
    """(M, ceil(K/32)) uint32 per-point observer bitmask: bit k of word w
    set iff keyframe slot 32w+k observes the point.

    One full-table scatter — built once per
    keyframe step and cached; per-frame consumers (local-keyframe voting)
    then pay a 2048-row gather instead of their own 262K-element sweep.
    The scatter is an idempotent boolean max (OR), so duplicate
    observations a fuse-merge may leave in one row cannot corrupt it."""
    Mc = ms.mp_pos.shape[0]
    K, N = ms.obs_mp.shape
    Wd = (K + 31) // 32
    obs = jnp.where(ms.kf_valid[:, None], ms.obs_mp, -1)
    kf_of = jnp.broadcast_to(jnp.arange(K, dtype=jnp.int32)[:, None], (K, N))
    tbl = jnp.zeros((Mc + 1, Wd * 32), jnp.bool_).at[
        jnp.where(obs >= 0, obs, Mc).reshape(-1),
        kf_of.reshape(-1)].max(True, mode="drop")[:Mc]
    # pack bools -> uint32 words: exact f32 byte matvec (values < 256),
    # then byte shifts — avoids any serialized per-bit loop
    wts = jnp.asarray(2.0 ** np.arange(8), jnp.float32)
    by = jnp.einsum("mwbk,k->mwb",
                    tbl.reshape(Mc, Wd, 4, 8).astype(jnp.float32),
                    wts).astype(jnp.uint32)
    return (by[..., 0] | (by[..., 1] << 8) | (by[..., 2] << 16)
            | (by[..., 3] << 24))


def member_table(ids: jnp.ndarray, M: int) -> jnp.ndarray:
    """(M+1,) bool lookup table marking the given ids (invalid ids < 0
    dropped). One scatter + one gather per query instead of a binary
    search (searchsorted costs log(N) dependent gathers per element)."""
    tbl = jnp.zeros((M + 1,), bool)
    return tbl.at[jnp.where(ids >= 0, ids, M)].set(True, mode="drop"
                                                   ).at[M].set(False)


def covisibility_counts(ms: MapState, q: jnp.ndarray) -> jnp.ndarray:
    """(K,) number of map points shared between keyframe q and every other
    keyframe (replaces KeyFrame::UpdateConnections counting,
    /root/reference/src/KeyFrame.cc:483-)."""
    M = ms.mp_pos.shape[0]
    tbl = member_table(ms.obs_mp[q], M)
    obs = ms.obs_mp  # (K,N)
    hit = tbl[jnp.clip(obs, 0, M)] & (obs >= 0) & ms.kf_valid[:, None]
    counts = jnp.sum(hit, axis=1).astype(jnp.int32)
    return counts.at[q].set(0)


@jax.jit
def covisibility_matrix(ms: MapState) -> jnp.ndarray:
    """(K,K) shared-observation counts between all keyframe pairs (the full
    covisibility graph, ref KeyFrame::GetConnectedKeyFrames). Row-scanned
    (lax.map) so memory stays O(K*N)."""
    K, N = ms.obs_mp.shape
    M = ms.mp_pos.shape[0]
    obs = jnp.where(ms.kf_valid[:, None], ms.obs_mp, -1)

    def row(i):
        tbl = member_table(obs[i], M)
        hit = tbl[jnp.clip(obs, 0, M)] & (obs >= 0)
        c = jnp.sum(hit, axis=1).astype(jnp.int32)
        return c.at[i].set(0)

    return jax.lax.map(row, jnp.arange(K))


def best_covisible(ms: MapState, q: jnp.ndarray, k: int,
                   min_weight: int = 15):
    """Top-k covisible keyframes of q: (k,) idx, (k,) weight, (k,) valid."""
    counts = covisibility_counts(ms, q)
    w, idx = jax.lax.top_k(counts, k)
    return idx, w, w >= min_weight


def local_map_mask(ms: MapState, kf_idx: jnp.ndarray,
                   kf_mask: jnp.ndarray) -> jnp.ndarray:
    """(M,) bool: map points observed by any keyframe in the given set
    (replaces Tracking::UpdateLocalPoints)."""
    M = ms.mp_pos.shape[0]
    obs = jnp.where(kf_mask[:, None], ms.obs_mp[kf_idx], -1).reshape(-1)
    sl = jnp.where(obs >= 0, obs, M)
    mask = jnp.zeros((M,), bool).at[sl].set(True, mode="drop")
    return mask & ms.mp_valid


def gather_local_points(ms: MapState, mask: jnp.ndarray, cap: int):
    """Pack up to `cap` masked map points into a dense buffer.

    Returns (idx (cap,), valid (cap,)): the fixed-size local map used by
    projection matching (stands in for the mvpLocalMapPoints vector).
    Cumsum-scatter compaction — O(M) with no sort (top_k over the pool was
    the hot spot)."""
    M = mask.shape[0]
    pos = jnp.cumsum(mask.astype(jnp.int32)) - 1
    tgt = jnp.where(mask & (pos < cap), pos, cap)
    idx = jnp.zeros((cap,), jnp.int32).at[tgt].set(
        jnp.arange(M, dtype=jnp.int32), mode="drop")
    n = jnp.minimum(jnp.sum(mask.astype(jnp.int32)), cap)
    valid = jnp.arange(cap) < n
    return idx, valid


# ---------------------------------------------------------------------------
# Structural updates
# ---------------------------------------------------------------------------

def insert_keyframe(ms: MapState, slot: jnp.ndarray,
                    R: jnp.ndarray, t: jnp.ndarray,
                    xy, octave, desc, uright, depth, kp_valid, obs_mp,
                    frame_id, kf_ord=None, angle=None) -> MapState:
    """Write a keyframe into pool slot (ref Tracking::CreateNewKeyFrame +
    LocalMapping::ProcessNewKeyFrame insertion half)."""
    if kf_ord is None:
        kf_ord = slot
    if angle is None:
        angle = jnp.zeros_like(uright)
    return ms._replace(
        kp_angle=ms.kp_angle.at[slot].set(angle),
        kf_R=ms.kf_R.at[slot].set(R),
        kf_t=ms.kf_t.at[slot].set(t),
        kf_valid=ms.kf_valid.at[slot].set(True),
        kf_sparsified=ms.kf_sparsified.at[slot].set(False),
        kf_frame_id=ms.kf_frame_id.at[slot].set(frame_id),
        kf_ord=ms.kf_ord.at[slot].set(kf_ord),
        kf_miss=ms.kf_miss.at[slot].set(0),
        kp_xy=ms.kp_xy.at[slot].set(xy),
        kp_octave=ms.kp_octave.at[slot].set(octave),
        kp_desc=ms.kp_desc.at[slot].set(desc),
        kp_uright=ms.kp_uright.at[slot].set(uright),
        kp_depth=ms.kp_depth.at[slot].set(depth),
        kp_valid=ms.kp_valid.at[slot].set(kp_valid),
        obs_mp=ms.obs_mp.at[slot].set(obs_mp),
    )


def alloc_map_slots(ms: MapState, new_mask: jnp.ndarray):
    """Free-slot allocator: the k-th set bit of new_mask gets the k-th FREE
    pool slot. This is the fixed-capacity replacement for the reference's heap
    allocation + shared_ptr release (src/MapPoint.cc:227-254 SetBadFlag
    actually frees memory): slots of deleted points are recycled, so the
    fixed pool survives unbounded sequences.

    Returns (slots, ok): slots[i] is the allocated pool slot for feature i
    (== M when the pool is full and the point is dropped), ok = new_mask
    restricted to successful allocations."""
    Mc = ms.mp_valid.shape[0]
    free = ~ms.mp_valid & (ms.mp_quarantine <= 0)
    free_rank = jnp.cumsum(free.astype(jnp.int32)) - 1
    n_free = jnp.sum(free.astype(jnp.int32))
    # table: k-th free slot id
    tgt = jnp.where(free, free_rank, Mc)
    kth_free = jnp.full((Mc,), Mc, jnp.int32).at[tgt].set(
        jnp.arange(Mc, dtype=jnp.int32), mode="drop")
    rank = jnp.cumsum(new_mask.astype(jnp.int32)) - 1
    ok = new_mask & (rank < n_free)
    slots = jnp.where(ok, kth_free[jnp.clip(rank, 0, Mc - 1)], Mc)
    return slots.astype(jnp.int32), ok


def add_map_points(ms: MapState, slots: jnp.ndarray, valid: jnp.ndarray,
                   pos: jnp.ndarray, desc: jnp.ndarray, normal: jnp.ndarray,
                   min_dist: jnp.ndarray, max_dist: jnp.ndarray,
                   first_kf, first_ord=None, angle=None) -> MapState:
    """Batch-allocate map points into given slots where valid."""
    sl = jnp.where(valid, slots, ms.mp_pos.shape[0])  # drop invalid
    if first_ord is None:
        first_ord = first_kf
    if angle is None:
        angle = jnp.zeros_like(min_dist)
    return ms._replace(
        mp_angle=ms.mp_angle.at[sl].set(angle, mode="drop"),
        mp_pos=ms.mp_pos.at[sl].set(pos, mode="drop"),
        mp_desc=ms.mp_desc.at[sl].set(desc, mode="drop"),
        mp_normal=ms.mp_normal.at[sl].set(normal, mode="drop"),
        mp_min_dist=ms.mp_min_dist.at[sl].set(min_dist, mode="drop"),
        mp_max_dist=ms.mp_max_dist.at[sl].set(max_dist, mode="drop"),
        mp_valid=ms.mp_valid.at[sl].set(True, mode="drop"),
        mp_sparsified=ms.mp_sparsified.at[sl].set(False, mode="drop"),
        mp_first_kf=ms.mp_first_kf.at[sl].set(first_kf, mode="drop"),
        mp_first_ord=ms.mp_first_ord.at[sl].set(first_ord, mode="drop"),
        mp_visible=ms.mp_visible.at[sl].set(1, mode="drop"),
        mp_found=ms.mp_found.at[sl].set(1, mode="drop"),
    )


@jax.jit
def refresh_mp_refs(ms: MapState) -> MapState:
    """Re-point STALE point->reference-keyframe links at the point's oldest
    current valid observer. A link is stale when the stored slot was culled
    or recycled by a different keyframe (detected by creation-ordinal
    mismatch). Needed before pose-graph point re-anchoring (the reference's
    MapPoint::mpRefKF is re-assigned on EraseObservation,
    src/MapPoint.cc:190-200); fresh links are kept — the creating keyframe
    is the semantically right anchor."""
    K, N = ms.obs_mp.shape
    Mc = ms.mp_pos.shape[0]
    ref0 = jnp.clip(ms.mp_first_kf, 0, K - 1)
    fresh = ms.kf_valid[ref0] & (ms.kf_ord[ref0] == ms.mp_first_ord)
    obs = jnp.where(ms.kf_valid[:, None], ms.obs_mp, -1).reshape(-1)
    kf_of = jnp.broadcast_to(
        jnp.arange(K, dtype=jnp.int32)[:, None], (K, N)).reshape(-1)
    key = ms.kf_ord[kf_of] * K + kf_of          # packed (ordinal, slot)
    tgt = jnp.where(obs >= 0, obs, Mc)
    sentinel = jnp.iinfo(jnp.int32).max
    best = jnp.full((Mc,), sentinel, jnp.int32).at[tgt].min(
        key, mode="drop")
    fallback = jnp.where(best < sentinel, best % K, ms.mp_first_kf)
    ref = jnp.where(fresh, ms.mp_first_kf, fallback)
    return ms._replace(mp_first_kf=ref.astype(jnp.int32))


def delete_map_points(ms: MapState, kill_mask: jnp.ndarray) -> MapState:
    """Functional SetBadFlag for a batch of points: clear validity and every
    observation referencing them (ref src/MapPoint.cc:227-254). Freed slots
    enter a 2-step quarantine before the allocator may recycle them."""
    obs_bad = kill_mask[jnp.clip(ms.obs_mp, 0)] & (ms.obs_mp >= 0)
    return ms._replace(
        mp_valid=ms.mp_valid & ~kill_mask,
        mp_quarantine=jnp.where(kill_mask, 2, ms.mp_quarantine),
        obs_mp=jnp.where(obs_bad, -1, ms.obs_mp),
    )


def delete_keyframes(ms: MapState, kill_mask: jnp.ndarray) -> MapState:
    """Functional KeyFrame::SetBadFlag (ref src/KeyFrame.cc): drop KF and
    its observations (map points keep living; their obs count just drops)."""
    return ms._replace(
        kf_valid=ms.kf_valid & ~kill_mask,
        obs_mp=jnp.where(kill_mask[:, None], -1, ms.obs_mp),
        kp_valid=jnp.where(kill_mask[:, None], False, ms.kp_valid),
    )


def update_mp_stats(ms: MapState, mp_idx: jnp.ndarray, visible: jnp.ndarray,
                    found: jnp.ndarray) -> MapState:
    """Increase visible/found counters (ref MapPoint::IncreaseVisible/Found
    called from Tracking::SearchLocalPoints / TrackLocalMap)."""
    sl = jnp.where(visible | found, mp_idx, ms.mp_pos.shape[0])
    return ms._replace(
        mp_visible=ms.mp_visible.at[sl].add(visible.astype(jnp.int32), mode="drop"),
        mp_found=ms.mp_found.at[sl].add(found.astype(jnp.int32), mode="drop"),
    )


def recompute_mp_descriptors(ms: MapState, mp_idx: jnp.ndarray) -> MapState:
    """Recompute distinctive descriptor + normal/depth range for the given
    point slots (ref MapPoint::ComputeDistinctiveDescriptors +
    UpdateNormalAndDepth).

    Distinctive descriptor = the observation descriptor minimizing total
    Hamming distance to the others. For pool-scale batching we use the
    cheaper median-bit descriptor (bitwise majority vote), which minimizes
    the *sum* of Hamming distances over bits — a standard binary centroid;
    matching behavior is equivalent in practice.
    """
    # gather all observations of each target point: we do it by scanning the
    # full obs table once (masked), accumulating bit counts per point.
    M = ms.mp_pos.shape[0]
    obs = ms.obs_mp  # (K,N)
    valid_obs = (obs >= 0) & ms.kf_valid[:, None]
    flat_mp = jnp.where(valid_obs, obs, M).reshape(-1)
    # unpack descriptors to bits and scatter-add per point
    K, N, _ = ms.kp_desc.shape
    desc_flat = ms.kp_desc.reshape(K * N, 8)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = ((desc_flat[:, :, None] >> shifts[None, None, :]) & jnp.uint32(1))
    bits = bits.reshape(K * N, 256).astype(jnp.int32)
    bit_sum = jnp.zeros((M, 256), jnp.int32).at[flat_mp].add(bits, mode="drop")
    n_obs = jnp.zeros((M,), jnp.int32).at[flat_mp].add(
        valid_obs.reshape(-1).astype(jnp.int32), mode="drop")
    maj = (2 * bit_sum > n_obs[:, None]).reshape(M, 8, 32).astype(jnp.uint32)
    packed = jnp.sum(maj << shifts[None, None, :], axis=-1, dtype=jnp.uint32)
    new_desc = jnp.where((n_obs > 0)[:, None], packed, ms.mp_desc)

    # normals: mean of unit vectors point->camera-center over observing KFs
    cam_centers = -jnp.einsum("kij,ki->kj", ms.kf_R.transpose(0, 2, 1), ms.kf_t)
    # accumulate per point
    vec = cam_centers[:, None, :] - ms.mp_pos[jnp.clip(obs, 0)]  # (K,N,3)
    vec = vec / (jnp.linalg.norm(vec, axis=-1, keepdims=True) + 1e-9)
    vec = jnp.where(valid_obs[..., None], vec, 0.0)
    nrm_sum = jnp.zeros((M, 3), ms.mp_pos.dtype).at[flat_mp].add(
        vec.reshape(K * N, 3), mode="drop")
    normal = nrm_sum / (jnp.maximum(n_obs, 1)[:, None])
    normal = normal / (jnp.linalg.norm(normal, axis=-1, keepdims=True) + 1e-9)
    new_normal = jnp.where((n_obs > 0)[:, None], normal, ms.mp_normal)
    return ms._replace(mp_desc=new_desc, mp_normal=new_normal)
