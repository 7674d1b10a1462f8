#!/usr/bin/env python
"""EuRoC stereo driver (ref /root/reference/Examples/Stereo/stereo_euroc.cc).

Usage: stereo_euroc.py <settings.yaml> <mav0_dir> [--out traj.txt]
"""
import argparse
import sys
import time

sys.path.insert(0, ".")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("settings")
    ap.add_argument("mav_dir")
    ap.add_argument("--out", default="CameraTrajectory_euroc.txt")
    ap.add_argument("--max-frames", type=int, default=None)
    args = ap.parse_args()

    from ms_slam.utils.runtime import setup_compile_cache
    setup_compile_cache()

    from ms_slam.pipeline.system import System
    from ms_slam.utils import native
    from ms_slam.utils.config import Settings
    from ms_slam.utils.datasets import EurocStereo, with_lookahead

    st = Settings(args.settings)
    cfg = st.system_config()
    rect = None
    need = ["K_l", "K_r", "D_l", "D_r", "R_l", "R_r", "P_l", "P_r"]
    if all(k in st.flat for k in need):
        rect = {k: st.flat[k] for k in need}
        rect["rows"] = st.get("LEFT.height", "Camera.height", required=True)
        rect["cols"] = st.get("LEFT.width", "Camera.width", required=True)
    ds = EurocStereo(args.mav_dir, rect_from_settings=rect)
    slam = System(cfg)
    print(f"native prefetch: {'ON' if native.available() else 'off'}",
          file=sys.stderr)
    times = []
    n = len(ds) if args.max_frames is None else min(len(ds), args.max_frames)
    # native decode+rectify workers run ahead; the next pair's frontend
    # overlaps this frame's host work (depth-2 device pipeline)
    for i, (fr, nxt) in enumerate(with_lookahead(ds.frames())):
        if i >= n:
            break
        t0 = time.perf_counter()
        slam.track_stereo(fr.left, fr.right, fr.timestamp, next_images=nxt)
        times.append(time.perf_counter() - t0)
        if i % 50 == 0:
            print(f"frame {i}/{n} state={slam.state} "
                  f"kf={slam.keyframes_in_map()} "
                  f"mp={slam.map_points_in_map()}", file=sys.stderr)
    slam.shutdown()
    slam.save_trajectory_tum(args.out)
    import numpy as np
    print(f"mean tracking time: {np.mean(times[3:]):.4f}")
    print(f"trajectory saved to {args.out}")


if __name__ == "__main__":
    main()
