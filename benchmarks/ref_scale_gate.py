#!/usr/bin/env python
"""Reference-scale end-to-end gate (VERDICT r2 item 3).

Runs the FULL system at the actual KITTI-00 parameterization — 2000
features, 8 pyramid levels, KITTI frame geometry (1241x376 -> 1248x384),
Sparsification.N=100, Lambda=500, GridLambda=10, WindowLength=30,
NonLocalKF=30 (ref /root/reference/Examples/Stereo/KITTI00-02.yaml:35-75)
— over a long synthetic circuit that returns to its start (loop-closure
opportunity), and checks the reference's implicit gates:

  - <= 15% of created map points kept by the sparsifier
    (ref README.md:49 reports 10.9% on KITTI-00)
  - >= 70% measured map-memory reduction (ref README.md:29/49 '>70%')
  - the loop actually closes through place recognition
  - ATE RMSE under 2% of path length

Usage: python benchmarks/ref_scale_gate.py [--frames 1000]
Prints one JSON line; exits nonzero if a gate fails.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))



def circuit(n_frames: int, radius: float = 9.0, lap: int = 1000):
    """Closed loop: drive a circle of the given radius facing forward,
    then keep driving INTO a second lap (KITTI-00's loop structure in
    miniature — the revisit is an extended moving overlap, not a parked
    endpoint, so place recognition gets a stream of revisit keyframes to
    confirm against, ref LoopClosing's 3-consecutive rule)."""
    from scipy.spatial.transform import Rotation
    poses = []
    for i in range(n_frames):
        a = 2 * np.pi * i / lap
        T = np.eye(4)
        # camera at radius, facing tangentially (z forward)
        T[:3, :3] = Rotation.from_euler("y", a).as_matrix()
        T[:3, 3] = [radius * np.sin(a), 0.0, radius * (1 - np.cos(a))]
        poses.append(T)
    return poses


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=1500)
    ap.add_argument("--no-sparsify", action="store_true",
                    help="bisect: odometry+loop only")
    ap.add_argument("--no-loop", action="store_true",
                    help="bisect: raw odometry (+sparsify)")
    ap.add_argument("--dump-traj", default=None,
                    help="write est/gt xyz per frame to this npz")
    args = ap.parse_args()

    from ms_slam.utils import runtime

    runtime.setup_compile_cache()
    # refuses a non-GPU platform; names the card before any number
    for line in runtime.device_banner():
        print(f"# {line}", file=sys.stderr, flush=True)

    from ms_slam.models.map_state import MapConfig
    from ms_slam.ops.orb import OrbConfig
    from ms_slam.pipeline.frontend import Calib
    from ms_slam.pipeline.system import System, SystemConfig
    from ms_slam.utils import synth
    from ms_slam.utils.evaluate import ate_rmse

    H, W = 384, 1248
    FX = 718.856
    BL = 0.537
    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])
    calib = Calib(model=0, params=(FX, FX, W / 2, H / 2),
                  bf=FX * BL, width=W, height=H,
                  th_depth=BL * 40, fps=10.0)
    cfg = SystemConfig(
        calib=calib,
        orb=OrbConfig(n_features=2048, n_levels=8),
        map=MapConfig(max_kf=256, max_mp=65536, n_feat=2048,
                      local_mp_cap=4096, window_kf=6),
        min_init_depth_points=300,
        max_frames_between_kf=10,
        # the REFERENCE KITTI parameterization, unscaled
        sparsify=not args.no_sparsify, sparsify_n=100, sparsify_lambda=500.0,
        sparsify_grid_lambda=10.0, sparsify_window=30,
        sparsify_queue_min=11, nonlocal_kf=30,
        loop_closing=not args.no_loop,
    )

    rng = np.random.default_rng(0)
    world = synth.BoxWorld(rng, half=24.0)
    n = args.frames
    poses = circuit(n)

    slam = System(cfg)
    t0 = time.time()
    prev = None
    for i, T in enumerate(poses):
        im_l, im_r = world.render_stereo(K, T, BL, H, W)
        if prev is not None:
            slam.track_stereo(*prev[0], prev[1], next_images=(im_l, im_r))
        prev = ((im_l, im_r), 0.1 * i)
        if i % 200 == 0:
            nw = (slam._sparsifier.stats["windows"]
                  if slam._sparsifier is not None else 0)
            nl = (slam._loop_closer.stats["loops"]
                  if slam._loop_closer is not None else 0)
            print(f"# frame {i}/{n} state={slam.state} "
                  f"kf={slam.keyframes_in_map()} "
                  f"mp={slam.map_points_in_map()} "
                  f"windows={nw} loops={nl}", file=sys.stderr)
    slam.track_stereo(*prev[0], prev[1])
    slam.shutdown()
    wall = time.time() - t0

    stats = slam.memory_stats()
    sp = (slam._sparsifier.stats if slam._sparsifier is not None
          else {"windows": 0, "kept": 0, "killed": 0})
    lc = (slam._loop_closer.stats if slam._loop_closer is not None
          else {"loops": 0})
    kept_frac = sp["kept"] / max(sp["kept"] + sp["killed"], 1)

    gt_by_ts = {round(0.1 * i, 6): T for i, T in enumerate(poses)}
    rows = slam.poses_wc()
    est = np.stack([T[:3, 3] for _, T in rows])
    gt = np.stack([gt_by_ts[round(ts, 6)][:3, 3] for ts, _ in rows])
    path = float(np.sum(np.linalg.norm(np.diff(gt, axis=0), axis=1)))
    rmse = float(ate_rmse(est, gt))
    if args.dump_traj:
        np.savez(args.dump_traj, est=est, gt=gt,
                 ts=np.array([ts for ts, _ in rows]))

    result = {
        "frames": n,
        "wall_s": round(wall, 1),
        "state": str(slam.state),
        "keyframes": slam.keyframes_in_map(),
        "sparsify_windows": sp["windows"],
        "points_kept_frac": round(kept_frac, 4),
        "mem_reduction": round(stats["reduction"], 4),
        "loops_closed": lc["loops"],
        "ate_rmse_m": round(rmse, 3),
        "path_m": round(path, 1),
        "gates": {
            "kept<=0.15": kept_frac <= 0.15,
            "mem_reduction>=0.70": stats["reduction"] >= 0.70,
            "loop_closed": lc["loops"] >= 1,
            "ate<=2%path": rmse <= 0.02 * path,
        },
    }
    print(json.dumps(result))
    if not all(result["gates"].values()):
        sys.exit(1)


if __name__ == "__main__":
    main()
