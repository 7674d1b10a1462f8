#!/usr/bin/env python
"""EuRoC stereo-inertial driver
(ref /root/reference/Examples/Stereo-Inertial/stereo_inertial_euroc.cc:
interleaves IMU measurement batches into TrackStereo :236-253).

Usage: stereo_inertial_euroc.py <settings.yaml> <mav0_dir> [--out traj.txt]
"""
import argparse
import sys
import time

import numpy as np

sys.path.insert(0, ".")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("settings")
    ap.add_argument("mav_dir")
    ap.add_argument("--out", default="CameraTrajectory_vi.txt")
    ap.add_argument("--max-frames", type=int, default=None)
    args = ap.parse_args()

    from ms_slam.utils.runtime import setup_compile_cache
    setup_compile_cache()

    from ms_slam.pipeline.system import System
    from ms_slam.utils.config import Settings
    from ms_slam.utils.datasets import EurocStereo

    st = Settings(args.settings)
    cfg = st.system_config()
    cfg.use_imu = True
    rect = None
    need = ["K_l", "K_r", "D_l", "D_r", "R_l", "R_r", "P_l", "P_r"]
    if all(k in st.flat for k in need):
        rect = {k: st.flat[k] for k in need}
        rect["rows"] = st.get("LEFT.height", "Camera.height", required=True)
        rect["cols"] = st.get("LEFT.width", "Camera.width", required=True)
    ds = EurocStereo(args.mav_dir, rect_from_settings=rect, with_imu=True)
    slam = System(cfg)
    times = []
    prev_t = None
    n = len(ds) if args.max_frames is None else min(len(ds), args.max_frames)
    for i, fr in enumerate(ds):
        if i >= n:
            break
        t0 = time.perf_counter()
        if fr.imu is not None and len(fr.imu) and prev_t is not None:
            # csv rows [t, a, g] -> [dt, a, g]
            ts = fr.imu[:, 0]
            dts = np.diff(np.concatenate([[prev_t], ts]))
            rows = np.concatenate([dts[:, None], fr.imu[:, 1:]], axis=1)
            slam.track_stereo_imu(fr.left, fr.right, fr.timestamp, rows)
        else:
            slam.track_stereo(fr.left, fr.right, fr.timestamp)
        prev_t = fr.timestamp
        times.append(time.perf_counter() - t0)
        if i % 50 == 0:
            print(f"frame {i}/{n} state={slam.state} "
                  f"kf={slam.keyframes_in_map()} "
                  f"imu_init={slam.imu_initialized}", file=sys.stderr)
    slam.shutdown()
    slam.save_trajectory_tum(args.out)
    print(f"mean tracking time: {np.mean(times[3:]):.4f}")
    print(f"imu initialized: {slam.imu_initialized}")
    print(f"trajectory saved to {args.out}")


if __name__ == "__main__":
    main()
