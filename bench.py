"""Benchmark: FULL-SYSTEM stereo tracking throughput on KITTI-sized frames.

Runs the complete per-frame pipeline — ORB frontend + stereo + local-map
tracking + keyframe/local-mapping + sliding-window MAP SPARSIFICATION +
LOOP-CLOSING place recognition (all four reference "threads") — on a
rendered synthetic world at KITTI geometry (1241x376 -> padded 1248x384,
2048 features, reference config Examples/Stereo/KITTI00-02.yaml:
Sparsification.N=100, Lambda=500, GridLambda=10) and reports steady-state
frames/s.

Baseline: the reference runs KITTI stereo in real time on CPU with all four
threads live; ORB-SLAM3's published mean stereo tracking time on KITTI-class
sequences is ~40ms/frame (~25 fps). vs_baseline = our_fps / 25.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

# the bench pins pipeline depth 4; which depth a local card needs is an
# open question (ROADMAP C1)
os.environ.setdefault("MSSLAM_PIPELINE_DEPTH", "4")

BASELINE_FPS = 25.0


def main():
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

    H, W = 384, 1248
    FX = 718.856
    BASELINE = 0.537  # KITTI stereo baseline (m)
    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])

    calib = Calib(model=0, params=(FX, FX, W / 2, H / 2),
                  bf=FX * BASELINE, width=W, height=H,
                  th_depth=BASELINE * 40, fps=10.0)
    cfg = SystemConfig(
        calib=calib,
        orb=OrbConfig(n_features=2048, n_levels=8),
        map=MapConfig(max_kf=128, max_mp=32768, n_feat=2048,
                      local_mp_cap=4096, window_kf=6),
        min_init_depth_points=300,
        max_frames_between_kf=10,
        # the reference's local BA is 5+5 Levenberg iterations WITH an
        # abort flag that interrupts it whenever a new keyframe arrives
        # (mbAbortBA, src/LocalMapping.cc:106); 3+3 uninterrupted fused
        # iterations is the comparable budget
        ba_iters=6,
        # the headline feature runs IN the measured loop at the FULL
        # reference KITTI parameterization: N=100, Lambda=500, GridLambda
        # =10, WindowLength=30, NonLocalKF=30, trigger queue>10
        # (ref Examples/Stereo/KITTI00-02.yaml:69-75,
        # src/MapSparsification.cc:194-199)
        sparsify=True, sparsify_n=100, sparsify_lambda=500.0,
        sparsify_grid_lambda=10.0, sparsify_window=30,
        sparsify_queue_min=11, nonlocal_kf=30,
        loop_closing=True,
    )

    rng = np.random.default_rng(0)
    n_frames = int(os.environ.get("BENCH_FRAMES", "600"))
    # forward drive through a street canyon (side walls + road): the
    # KITTI-00 motion AND geometry profile — near structure in every frame,
    # unbounded along the driving direction. The turn-heavy/loop-closing
    # regime is covered by benchmarks/ref_scale_gate.py.
    world = synth.CorridorWorld(rng, half_w=6.0, y_floor=1.7)
    poses = synth.make_trajectory(n_frames, "forward")

    t0 = time.time()
    # stage frames as uint8 up front: the measured loop should pay upload +
    # compute, not per-frame float->byte conversion on the (2-core) host
    frames = [tuple(np.clip(im, 0, 255).astype(np.uint8) for im in
                    world.render_stereo(K, T, BASELINE, H, W))
              for T in poses]
    print(f"# rendered {n_frames} frames in {time.time()-t0:.1f}s",
          file=sys.stderr)

    def run(tag, n=None, cfg_run=None):
        n = n or n_frames
        slam = System(cfg_run or cfg)
        t0 = time.time()
        for i in range(n):
            nxt = frames[i + 1] if i + 1 < n else None
            slam.track_stereo(frames[i][0], frames[i][1], 0.1 * i,
                              next_images=nxt)
        slam._flush_pipeline()
        dt = time.time() - t0
        print(f"# {tag}: {n} frames in {dt:.2f}s; "
              f"state={slam.state} kf={slam.keyframes_in_map()} "
              f"mp={slam.map_points_in_map()} "
              f"sparsified_windows={slam._sparsifier.stats['windows']} "
              f"lc_queries={slam._loop_closer.stats['queries']}",
              file=sys.stderr)
        if os.environ.get("BENCH_VERBOSE"):
            slam.print_time_stats()
        return n / dt

    # pass 1 compiles every kernel (tracking, keyframe + mapping,
    # sparsification windows, loop-closing queries) on a 220-frame prefix.
    # The sparsifier/loop kernels are shape-identical across the host-side
    # NonLocalKF/queue thresholds, so the warmup config lowers them to make
    # the first window + retrieval queries fire inside the prefix (at the
    # reference thresholds they first fire around frame ~450); pass 2 on a
    # fresh System at the REFERENCE parameterization measures steady-state
    # throughput — what the always-on reference process delivers (it pays
    # no JIT either)
    import dataclasses
    warm_cfg = dataclasses.replace(cfg, nonlocal_kf=3, sparsify_queue_min=2)
    run("warmup", n=min(220, n_frames), cfg_run=warm_cfg)
    fps = run("measured")
    print(json.dumps({
        "metric": "stereo_track_fps_kitti_size_full_system",
        "value": round(fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(fps / BASELINE_FPS, 3),
    }))


if __name__ == "__main__":
    main()
