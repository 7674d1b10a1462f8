#!/usr/bin/env python
"""Smoke run of the full SLAM path on one NVIDIA GPU.

Drives the system the way a user's driver does — `Settings(yaml)
.system_config()`, then `System.track_stereo` / `track_stereo_imu` frame by
frame — on frames rendered from a seed, at the published widths of two
deployments, and checks the results:

  1. device   the first JAX device is a GPU (no fallback); prints the card
              name and power limit and the compile-cache directory;
  2. stereo   KITTI 00-02 (configs/KITTI00-02.yaml as it stands: 1241x376,
              2048 features, 8 levels, sparsification N=100 / Lambda=500 /
              NonLocalKF=30, loop closing) on a circuit that revisits its
              start: state OK,
              at least one sparsification window, at least one closed loop
              (essential-graph correction + global BA), ATE <= 2% of path;
  3. inertial EuRoC stereo-inertial (configs/EuRoC-Inertial.yaml: 752x480,
              1280 features, IMU at 200 Hz in the body frame of the
              config's T_b_c1): IMU initialized, state OK, ATE <= 2% of path;
  4. parity   ORB, hamming_matrix, pose_optimize and the window BA on the
              GPU against the same computation on the CPU backend, at the
              deployment's widths (ms_slam/utils/parity.py).

Any failure raises, and the script exits non-zero without printing the
last line. On success the last line is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Usage: python chip_smoke.py
"""
from __future__ import annotations

import json
import os
import time

T_START = time.perf_counter()

import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
KITTI_YAML = os.path.join(HERE, "configs", "KITTI00-02.yaml")
EUROC_YAML = os.path.join(HERE, "configs", "EuRoC-Inertial.yaml")
# the circuit: one lap of LAP frames, then far enough into the second lap
# for place recognition to confirm the revisit (3 consecutive keyframes);
# at the reference thresholds the first window and loop come at frames
# ~175 and ~300-350 of this circuit
STEREO_LAP = 300
STEREO_FRAMES = 450
INERTIAL_FRAMES = 200


def log(msg: str):
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phase 1: device
# ---------------------------------------------------------------------------

def phase_device():
    """Returns (device, label): label is the card's name and power limit,
    printed beside every number."""
    import jax

    from ms_slam.utils import runtime

    cache_dir = runtime.setup_compile_cache()
    for line in runtime.device_banner():          # raises without a GPU
        log(line)
    log(f"compile cache: {cache_dir}")
    return jax.devices()[0], runtime.gpu_name_and_power_limit()


# ---------------------------------------------------------------------------
# shared: rendering, timing, accuracy
# ---------------------------------------------------------------------------

def circuit(n_frames: int, lap: int, radius: float):
    """Camera-to-world poses driving a circle facing forward, continuing
    into a second lap (the revisit is an extended overlap, not a parked
    endpoint)."""
    from scipy.spatial.transform import Rotation
    poses = []
    for i in range(n_frames):
        a = 2 * np.pi * i / lap
        T = np.eye(4)
        T[:3, :3] = Rotation.from_euler("y", a).as_matrix()
        T[:3, 3] = [radius * np.sin(a), 0.0, radius * (1 - np.cos(a))]
        poses.append(T)
    return poses


def wobble(n_frames: int, dt: float):
    """Hand-held/MAV-like motion: a swept arc with a vertical bob, so the
    accelerometer sees a few m/s^2 of variation (inertial init needs it)."""
    from scipy.spatial.transform import Rotation
    poses = []
    for i in range(n_frames):
        t = dt * i
        w = 2 * np.pi * t / 8.0
        T = np.eye(4)
        T[:3, :3] = Rotation.from_euler("y", 0.3 * np.sin(w)).as_matrix()
        T[:3, 3] = [1.5 * np.sin(w), 0.25 * np.sin(2 * np.pi * t / 2.5),
                    1.0 * (1 - np.cos(w))]
        poses.append(T)
    return poses


def intrinsics(calib):
    fx, fy, cx, cy = calib.params[:4]
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    return K, calib.bf / fx, calib.height, calib.width


def render_all(world, K, baseline, h, w, poses):
    """uint8 stereo pairs for every pose (threads: numpy releases the GIL)."""
    from concurrent.futures import ThreadPoolExecutor

    def one(T):
        return tuple(np.clip(im, 0, 255).astype(np.uint8)
                     for im in world.render_stereo(K, T, baseline, h, w))
    with ThreadPoolExecutor(8) as ex:
        return list(ex.map(one, poses))


class CompileCounter:
    """Counts XLA backend compilations and their seconds from its creation
    on (a JAX monitoring listener; it cannot be removed again)."""

    def __init__(self):
        import jax
        self.n = 0
        self.secs = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **_):
        if event == "/jax/core/compile/backend_compile_duration":
            self.n += 1
            self.secs += duration


def drive(slam, frames, step, cc: CompileCounter):
    """Feed every frame; returns per-frame wall seconds of frames in which
    nothing compiled, the number of frames that compiled, and the total
    seconds. step(i, frame, next_frame) makes the user-facing call."""
    steady, compiled = [], 0
    t0 = time.perf_counter()
    for i in range(len(frames)):
        n0 = cc.n
        t = time.perf_counter()
        step(i, frames[i], frames[i + 1] if i + 1 < len(frames) else None)
        if cc.n == n0:
            steady.append(time.perf_counter() - t)
        else:
            compiled += 1
    slam._flush_pipeline()
    return np.asarray(steady), compiled, time.perf_counter() - t0


def ate(slam, poses, dt):
    """(ATE RMSE after Horn alignment, ground-truth path length) over the
    final trajectory."""
    from ms_slam.utils.evaluate import ate_rmse
    gt = {round(dt * i, 6): T for i, T in enumerate(poses)}
    rows = slam.poses_wc()
    est = np.stack([T[:3, 3] for _, T in rows])
    ref = np.stack([gt[round(ts, 6)][:3, 3] for ts, _ in rows])
    path = float(np.sum(np.linalg.norm(np.diff(ref, axis=0), axis=1)))
    return float(ate_rmse(est, ref)), path


def peak_bytes():
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use", "not reported")


def summarize(slam, poses, dt, steady, compiled, t_track, t_render,
              cc: CompileCounter):
    rmse, path = ate(slam, poses, dt)
    mem = slam.memory_stats()
    sp = slam._sparsifier.stats if slam._sparsifier else {}
    lc = slam._loop_closer.stats if slam._loop_closer else {}
    kept, killed = sp.get("kept", 0), sp.get("killed", 0)
    return {
        "frames": len(poses), "state": str(slam.state),
        "keyframes": slam.keyframes_in_map(),
        "map_points": slam.map_points_in_map(),
        "points_kept_frac": kept / max(kept + killed, 1),
        "mem_reduction": mem["reduction"],
        "sparsify_windows": sp.get("windows", 0),
        "loops": lc.get("loops", 0),
        "imu_initialized": bool(getattr(slam, "imu_initialized", False)),
        "ate_m": rmse, "path_m": path,
        "render_s": t_render, "track_s": t_track,
        "compile_s": cc.secs, "frames_with_compile": compiled,
        "track_stereo_median_ms":
            float(np.median(steady)) * 1e3 if len(steady) else None,
        "track_stereo_p99_ms":
            float(np.percentile(steady, 99)) * 1e3 if len(steady) else None,
        "steady_frames": len(steady),
        "peak_bytes_in_use": peak_bytes(),
    }


def report(phase: str, label: str, stats: dict):
    for k, v in stats.items():
        log(f"[{label}] {phase} {k}={v}")


# ---------------------------------------------------------------------------
# phase 2: stereo
# ---------------------------------------------------------------------------

def stereo_config():
    """The KITTI 00-02 deployment, unmodified."""
    from ms_slam.utils.config import Settings
    return Settings(KITTI_YAML).system_config()


def run_stereo(cfg, n_frames=STEREO_FRAMES, lap=STEREO_LAP, radius=9.0,
               room_half=24.0, seed=0) -> dict:
    from ms_slam.pipeline.system import System
    from ms_slam.utils import synth

    cc = CompileCounter()
    rng = np.random.default_rng(seed)
    world = synth.BoxWorld(rng, half=room_half)
    K, bl, h, w = intrinsics(cfg.calib)
    poses = circuit(n_frames, lap, radius)
    t0 = time.perf_counter()
    frames = render_all(world, K, bl, h, w, poses)
    t_render = time.perf_counter() - t0
    dt = 1.0 / cfg.calib.fps
    slam = System(cfg)

    def step(i, fr, nxt):
        slam.track_stereo(fr[0], fr[1], dt * i, next_images=nxt)

    steady, compiled, t_track = drive(slam, frames, step, cc)
    state = str(slam.state)
    slam.shutdown()
    out = summarize(slam, poses, dt, steady, compiled, t_track, t_render,
                    cc)
    out["state"] = state
    return out


def require(ok: bool, what: dict):
    """A failed check raises (kept under python -O, unlike assert)."""
    if not ok:
        raise AssertionError(what)


def check_stereo(s: dict):
    require(s["state"] == "OK" and s["sparsify_windows"] >= 1
            and s["loops"] >= 1 and s["ate_m"] <= 0.02 * s["path_m"], s)


# ---------------------------------------------------------------------------
# phase 3: stereo-inertial
# ---------------------------------------------------------------------------

def inertial_config():
    from ms_slam.utils.config import Settings
    return Settings(EUROC_YAML).system_config()


def run_inertial(cfg, n_frames=INERTIAL_FRAMES, seed=1) -> dict:
    """Camera poses from `wobble`; the IMU is synthesized along the BODY
    trajectory T_wb = T_wc * T_cb of the config's extrinsic."""
    from ms_slam.pipeline.system import System
    from ms_slam.utils import synth

    cc = CompileCounter()
    rng = np.random.default_rng(seed)
    world = synth.PlaneWorld(rng, z_wall=14.0, y_floor=2.0)
    K, bl, h, w = intrinsics(cfg.calib)
    dt = 1.0 / cfg.calib.fps
    poses = wobble(n_frames, dt)
    Tbc = np.eye(4) if cfg.Tbc is None else np.asarray(cfg.Tbc, np.float64)
    T_cb = np.linalg.inv(Tbc)
    imu = synth.make_imu([T @ T_cb for T in poses], dt, imu_rate=200)
    t0 = time.perf_counter()
    frames = render_all(world, K, bl, h, w, poses)
    t_render = time.perf_counter() - t0
    slam = System(cfg)

    def step(i, fr, nxt):
        if i == 0:
            slam.track_stereo(fr[0], fr[1], 0.0)
        else:
            slam.track_stereo_imu(fr[0], fr[1], dt * i, imu[i - 1])

    steady, compiled, t_track = drive(slam, frames, step, cc)
    state = str(slam.state)
    slam.shutdown()
    out = summarize(slam, poses, dt, steady, compiled, t_track, t_render,
                    cc)
    out["state"] = state
    return out


def check_inertial(s: dict):
    require(s["imu_initialized"] and s["state"] == "OK"
            and s["ate_m"] <= 0.02 * s["path_m"], s)


# ---------------------------------------------------------------------------
# phase 4: parity against the CPU backend
# ---------------------------------------------------------------------------

def run_parity(dev, ref_dev, cfg, pair=None) -> dict:
    """Every check of utils.parity on dev against ref_dev at cfg's widths:
    ORB on a stereo pair (rendered at cfg's image size unless given),
    hamming of a frame's descriptors against the local map's, pose
    optimization over a frame's features, and the window BA (window plus
    fixed keyframes, the local point cap)."""
    from ms_slam.utils import parity, synth
    if pair is None:
        K, bl, h, w = intrinsics(cfg.calib)
        world = synth.BoxWorld(np.random.default_rng(2), half=24.0)
        T = circuit(1, 300, 9.0)[0]
        pair = np.stack(render_all(world, K, bl, h, w, [T])[0])
    n, cap = cfg.orb.n_features, cfg.map.local_mp_cap
    return {
        "orb": parity.orb_parity(dev, ref_dev, pair, cfg.orb),
        "hamming": parity.hamming_parity(dev, ref_dev, n, cap),
        "pose_opt": parity.pose_opt_parity(dev, ref_dev, n=n),
        "ba": parity.ba_parity(
            dev, ref_dev, n_cams=cfg.map.window_kf + cfg.n_fixed_cams,
            n_feat=n, n_pts=cap),
    }


# ---------------------------------------------------------------------------

def main():
    dev, label = phase_device()
    import jax

    t = time.perf_counter()
    s = run_stereo(stereo_config())
    report("stereo", label, s)
    check_stereo(s)
    log(f"[{label}] stereo phase_s={time.perf_counter() - t}")

    t = time.perf_counter()
    s = run_inertial(inertial_config())
    report("inertial", label, s)
    check_inertial(s)
    log(f"[{label}] inertial phase_s={time.perf_counter() - t}")

    t = time.perf_counter()
    par = run_parity(dev, jax.devices("cpu")[0], stereo_config())
    for k, v in par.items():
        log(f"[{label}] parity {k} {json.dumps(v)}")
    log(f"[{label}] parity phase_s={time.perf_counter() - t}")

    log(f"[{label}] total_s={time.perf_counter() - T_START}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
