#!/usr/bin/env python
"""4Seasons stereo-inertial driver
(ref /root/reference/Examples/Stereo-Inertial/stereo_inertial_4season.cc).

4Seasons layout: <seq>/undistorted_images/cam0|cam1/<t_ns>.png,
<seq>/times.txt (id t_s ...), <seq>/imu.txt (t_ns gx gy gz ax ay az).

Usage: stereo_inertial_4season.py <settings.yaml> <seq_dir> [--out traj.txt]
"""
import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, ".")


def load_4season(seq):
    times = []
    with open(os.path.join(seq, "times.txt")) as f:
        for line in f:
            if line.startswith("#"):
                continue
            v = line.split()
            times.append((v[0], float(v[1])))
    imu = []
    imu_path = os.path.join(seq, "imu.txt")
    if os.path.exists(imu_path):
        with open(imu_path) as f:
            for line in f:
                if line.startswith("#"):
                    continue
                v = [float(x) for x in line.split()]
                imu.append([v[0] * 1e-9, v[4], v[5], v[6], v[1], v[2], v[3]])
    return times, np.asarray(imu) if imu else None


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("settings")
    ap.add_argument("seq_dir")
    ap.add_argument("--out", default="CameraTrajectory_4s.txt")
    ap.add_argument("--max-frames", type=int, default=None)
    args = ap.parse_args()

    from ms_slam.utils.runtime import setup_compile_cache
    setup_compile_cache()

    import cv2

    from ms_slam.pipeline.system import System
    from ms_slam.utils.config import Settings

    st = Settings(args.settings)
    cfg = st.system_config()
    times, imu = load_4season(args.seq_dir)
    cfg.use_imu = imu is not None
    slam = System(cfg)
    prev_t = None
    tt = []
    n = len(times) if args.max_frames is None else min(len(times),
                                                       args.max_frames)
    for i, (fid, ts) in enumerate(times):
        if i >= n:
            break
        l = cv2.imread(os.path.join(args.seq_dir, "undistorted_images",
                                    "cam0", f"{fid}.png"),
                       cv2.IMREAD_GRAYSCALE)
        r = cv2.imread(os.path.join(args.seq_dir, "undistorted_images",
                                    "cam1", f"{fid}.png"),
                       cv2.IMREAD_GRAYSCALE)
        if l is None or r is None:
            continue
        t0 = time.perf_counter()
        if imu is not None and prev_t is not None:
            sel = (imu[:, 0] > prev_t) & (imu[:, 0] <= ts)
            rows = imu[sel]
            dts = np.diff(np.concatenate([[prev_t], rows[:, 0]])) \
                if len(rows) else np.zeros(0)
            rows = np.concatenate([dts[:, None], rows[:, 1:]], axis=1) \
                if len(rows) else np.zeros((0, 7))
            slam.track_stereo_imu(l.astype(np.float32), r.astype(np.float32),
                                  ts, rows)
        else:
            slam.track_stereo(l.astype(np.float32), r.astype(np.float32), ts)
        prev_t = ts
        tt.append(time.perf_counter() - t0)
        if i % 50 == 0:
            print(f"frame {i}/{n} state={slam.state} "
                  f"kf={slam.keyframes_in_map()} "
                  f"mp={slam.map_points_in_map()} "
                  f"compressed={slam.compressed_map_points_in_map()}",
                  file=sys.stderr)
    slam.shutdown()
    slam.save_trajectory_tum(args.out)
    print(f"mean tracking time: {np.mean(tt[3:]):.4f}")
    print(f"trajectory saved to {args.out}")


if __name__ == "__main__":
    main()
