#!/usr/bin/env python
"""Per-stage device time of the hot per-frame kernels on the GPU.

Each stage is jitted on its own, warmed up, then called N times inside a
jax.profiler trace; its device time per call is the union of the GPU
stream intervals in the trace divided by N (device_ms). Prints one line per
stage, after lines naming the card.

Usage: python benchmarks/kernel_profile.py [--out DIR]  (traces go to DIR)
"""
from __future__ import annotations

import glob
import os
import sys
import tempfile
import time
from functools import partial

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def busy_ns(intervals) -> int:
    """Length of the union of (start, end) intervals."""
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def device_lines(xplane_path: str) -> dict:
    """{line name: [(start_ns, end_ns), ...]} over every GPU plane."""
    from jax.profiler import ProfileData
    out = {}
    for plane in ProfileData.from_file(xplane_path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            ivs = out.setdefault(f"{plane.name}/{line.name}", [])
            for ev in line.events:
                ivs.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    return out


def device_ms(fn, n=20, warmup=2, trace_dir=None):
    """Device milliseconds per call of fn(): union of the GPU stream
    intervals of n back-to-back calls, over n. Each trace goes to a new
    directory under trace_dir (default: the system's temporary one)."""
    import jax
    for _ in range(warmup):
        jax.block_until_ready(fn())
    d = tempfile.mkdtemp(dir=trace_dir)
    jax.profiler.start_trace(d)
    out = None
    for _ in range(n):
        out = fn()
    jax.block_until_ready(out)
    jax.profiler.stop_trace()
    path = sorted(glob.glob(os.path.join(d, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    lines = device_lines(path)
    streams = [iv for name, ivs in lines.items() if "Stream" in name
               for iv in ivs]
    return busy_ns(streams) / n / 1e6


def main():
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="directory for the traces")
    dm = partial(device_ms, trace_dir=ap.parse_args().out)

    import jax

    from ms_slam.utils import runtime
    runtime.setup_compile_cache()
    for line in runtime.device_banner():
        print(line, flush=True)
    import jax.numpy as jnp

    from ms_slam.ops import orb, stereo, pose_opt
    from ms_slam.ops.orb import OrbConfig
    from ms_slam.pipeline.frontend import Calib, process_stereo_stacked
    from ms_slam.utils import synth

    H, W = 384, 1248
    FX = 718.856
    BL = 0.537
    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])
    calib = Calib(model=0, params=(FX, FX, W / 2, H / 2),
                  bf=FX * BL, width=W, height=H, th_depth=BL * 40)
    cfg = OrbConfig(n_features=2048, n_levels=8)

    rng = np.random.default_rng(0)
    world = synth.CorridorWorld(rng, half_w=6.0, y_floor=1.7)
    im_l, im_r = world.render_stereo(K, np.eye(4), BL, H, W)
    imgs = jnp.asarray(np.stack([im_l, im_r]).astype(np.uint8))
    imgs_f = imgs.astype(jnp.float32)

    B = 2
    offs, Wc, shapes = orb.canvas_layout(H, W, cfg)
    print(f"canvas width: {Wc}", flush=True)

    build = jax.jit(partial(orb.build_canvas_multi, cfg=cfg))
    canvas = build(imgs_f).block_until_ready()
    print(f"build_canvas:        {dm(lambda: build(imgs_f)):7.2f} ms")

    fs = jax.jit(partial(orb.fast_score_batched, min_th=cfg.min_th))
    print(f"fast_score:          {dm(lambda: fs(canvas)):7.2f} ms")

    det = jax.jit(partial(orb.detect_canvas, w=W, cfg=cfg))
    outs = det(canvas)
    print(f"detect_canvas(all):  {dm(lambda: det(canvas)):7.2f} ms")

    lv, ys, xs, sc, va = outs
    n = cfg.n_features
    bi = jnp.broadcast_to(jnp.arange(B, dtype=jnp.int32)[:, None],
                          (B, n)).reshape(-1)
    ysf, xsf = ys.reshape(-1), xs.reshape(-1)
    ep = jax.jit(orb.extract_patches_canvas)
    patches = ep(canvas, bi, ysf, xsf)
    print(f"extract_patches:     {dm(lambda: ep(canvas, bi, ysf, xsf)):7.2f} ms")

    ori = jax.jit(orb.orientation_from_patches)
    ang = ori(patches)
    print(f"orientation:         {dm(lambda: ori(patches)):7.2f} ms")

    des = jax.jit(orb.descriptors_from_patches)
    print(f"blur+descriptors:    {dm(lambda: des(patches, ang)):7.2f} ms")

    feats, canvases = jax.jit(partial(orb.extract_canvas_multi, cfg=cfg))(imgs_f)
    f_l = jax.tree.map(lambda a: a[0], feats)
    f_r = jax.tree.map(lambda a: a[1], feats)
    sm = jax.jit(partial(stereo.match_stereo_canvas, w=W,
                         bf=calib.bf, min_z=calib.min_z, cfg=cfg))
    print(f"stereo_match:        {dm(lambda: sm(f_l, f_r, canvases[0], canvases[1])):7.2f} ms")

    fused = partial(process_stereo_stacked, calib=calib, orb_cfg=cfg)
    print(f"frontend (fused):    {dm(lambda: fused(imgs)):7.2f} ms")

    # ---- tracking-side kernels on a populated map
    from ms_slam.models.map_state import MapConfig
    from ms_slam.pipeline.system import System, SystemConfig
    from ms_slam.pipeline import tracking_ops as to
    from ms_slam.models import map_state as M

    mc = MapConfig(max_kf=128, max_mp=32768, n_feat=2048,
                   local_mp_cap=4096, window_kf=6)
    scfg = SystemConfig(calib=calib, orb=cfg, map=mc,
                        min_init_depth_points=300, max_frames_between_kf=10)
    slam = System(scfg)
    for i, Tp in enumerate(synth.make_trajectory(40, "forward")):
        a, b = world.render_stereo(K, Tp, BL, H, W)
        slam.track_stereo(a, b, 0.1 * i)
    slam._flush_pipeline()
    ms = slam.ms
    frame = fused(imgs)
    jax.block_until_ready(frame)
    R0 = jnp.asarray(slam.last_R)
    t0 = jnp.asarray(slam.last_t)
    lm = slam.last_matched

    pt_idx = jnp.clip(lm, 0)
    pt_valid = lm >= 0
    tp = partial(to.track_points, calib=calib, orb_cfg=cfg)
    print(f"track_points(last):  {dm(lambda: tp(ms, frame=frame, R0=R0, t0=t0, pt_idx=pt_idx, pt_valid=pt_valid, th_radius=jnp.asarray(7.0), nn_ratio=jnp.asarray(0.9)), n=20):7.2f} ms")

    lk = jax.jit(partial(to.local_keyframes, k=10))
    idx, mask = lk(ms, lm)
    print(f"local_keyframes:     {dm(lambda: lk(ms, lm), n=20):7.2f} ms")

    lmm = jax.jit(M.local_map_mask)
    msk = lmm(ms, idx, mask)
    print(f"local_map_mask:      {dm(lambda: lmm(ms, idx, mask), n=20):7.2f} ms")

    glp = jax.jit(partial(M.gather_local_points, cap=mc.local_mp_cap))
    li, lval = glp(ms, msk)
    print(f"gather_local_points: {dm(lambda: glp(ms, msk), n=20):7.2f} ms")

    print(f"track_points(local): {dm(lambda: tp(ms, frame=frame, R0=R0, t0=t0, pt_idx=li, pt_valid=lval, th_radius=jnp.asarray(1.0), nn_ratio=jnp.asarray(0.8)), n=20):7.2f} ms")

    o2 = tp(ms, frame=frame, R0=R0, t0=t0, pt_idx=li, pt_valid=lval,
            th_radius=jnp.asarray(1.0), nn_ratio=jnp.asarray(0.8))
    mp_of = jnp.where(o2.matched_mp >= 0, o2.matched_mp, 0)
    X = ms.mp_pos[mp_of]
    has = o2.matched_mp >= 0
    po = jax.jit(partial(pose_opt.pose_optimize, calib.model))
    params = calib.params_array()
    print(f"pose_optimize:       {dm(lambda: po(params, jnp.asarray(calib.bf), R0, t0, X, frame.feats.xy, frame.u_right, frame.sigma2, has), n=20):7.2f} ms")

    # full track_full chained (donated ms) — true steady-state device cost
    import jax.tree_util as jtu
    msX = jtu.tree_map(lambda a: a + 0 if hasattr(a, "dtype") else a, ms)
    lmX, RX, tX = lm, R0, t0
    ref = jnp.asarray(slam.ref_kf)

    def chain(nn=30):
        nonlocal msX, lmX, RX, tX
        t0_ = time.perf_counter()
        out = None
        for _ in range(nn):
            out = to.track_full(msX, calib, cfg, frame, RX, tX, RX, tX,
                                jnp.asarray(True), lmX, ref, mc.local_mp_cap)
            msX, lmX, RX, tX = out.ms, out.matched_mp, out.R, out.t
        jax.block_until_ready(out.stats)
        return (time.perf_counter() - t0_) / nn * 1e3
    chain(3)
    print(f"track_full (chain, wall per call): {chain():7.2f} ms")


if __name__ == "__main__":
    main()
