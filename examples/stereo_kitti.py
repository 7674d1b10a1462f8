#!/usr/bin/env python
"""KITTI stereo driver.

Mirrors /root/reference/Examples/Stereo/stereo_kitti.cc: load the sequence,
track every pair, sample resident memory per frame (mem_usage() :33-54 reads
VmRSS from /proc/self/status), print peak memory and mean tracking time
(:149-185), save the KITTI-format trajectory (:187).

Usage: stereo_kitti.py <settings.yaml> <sequence_dir> [--out traj.txt]
                       [--max-frames N]
"""
import argparse
import sys
import time

sys.path.insert(0, ".")


def mem_usage_mb() -> float:
    """VmRSS in MB (ref stereo_kitti.cc:33-54)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS"):
                return float(line.split()[1]) / 1024.0
    return 0.0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("settings")
    ap.add_argument("sequence")
    ap.add_argument("--out", default="CameraTrajectory.txt")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--max-kf", type=int, default=512)
    args = ap.parse_args()

    from ms_slam.utils.runtime import setup_compile_cache
    setup_compile_cache()

    from ms_slam.pipeline.system import System
    from ms_slam.utils import native
    from ms_slam.utils.config import Settings
    from ms_slam.utils.datasets import KittiOdometry, with_lookahead

    st = Settings(args.settings)
    cfg = st.system_config(max_kf=args.max_kf)
    ds = KittiOdometry(args.sequence)
    slam = System(cfg)
    print(f"native prefetch: {'ON' if native.available() else 'off'}",
          file=sys.stderr)

    times, mems = [], []
    n = len(ds) if args.max_frames is None else min(len(ds), args.max_frames)
    # native decode workers run ahead of the loop; the NEXT pair rides into
    # track_stereo so its frontend overlaps this frame's host work (the
    # depth-2 device pipeline — what the reference gets from its threads)
    for i, (fr, nxt) in enumerate(with_lookahead(ds.frames())):
        if i >= n:
            break
        t0 = time.perf_counter()
        slam.track_stereo(fr.left, fr.right, fr.timestamp, next_images=nxt)
        times.append(time.perf_counter() - t0)
        mems.append(mem_usage_mb())
        if i % 50 == 0:
            print(f"frame {i}/{n} state={slam.state} "
                  f"kf={slam.keyframes_in_map()} "
                  f"mp={slam.map_points_in_map()} "
                  f"compressed={slam.compressed_map_points_in_map()} "
                  f"mem={mems[-1]:.0f}MB", file=sys.stderr)

    slam.shutdown()
    slam.save_trajectory_kitti(args.out)
    # reference-style report (stereo_kitti.cc:156-185)
    import numpy as np
    times = np.asarray(times[3:])
    print("-------")
    print(f"mean tracking time: {times.mean():.4f}")
    print(f"median tracking time: {np.median(times):.4f}")
    print(f"max memory usage: {max(mems):.1f} MB")
    print(f"map points: {slam.map_points_in_map()}")
    print(f"compressed map points: {slam.compressed_map_points_in_map()}")
    stats = slam.memory_stats()
    print(f"map memory reduction (measured): {stats['reduction']*100:.1f}% "
          f"({stats['live_bytes']/1e6:.2f} MB live map vs "
          f"{stats['without_sparsification_bytes']/1e6:.2f} MB had the "
          f"selector kept every point/slot)")
    print(f"trajectory saved to {args.out}")


if __name__ == "__main__":
    main()
