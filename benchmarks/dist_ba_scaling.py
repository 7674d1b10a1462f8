#!/usr/bin/env python
"""Distributed-BA scaling measurement (no reference counterpart exists —
MS-SLAM is single-process).

Times dist_ba_solve wall-clock on a large synthetic factor table over
1, 2, 4, ... of the GPUs JAX sees. The solver is the production
point-owned Schur-CG path: per-device Jacobian work scales 1/D, and the
reduced camera system is one (C*6,) psum collective per CG step.

Usage:  python benchmarks/dist_ba_scaling.py [--cams 96] [--pts 8192]
Prints the card lines, then one JSON line with the wall-clock table and
speedups.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cams", type=int, default=96)
    ap.add_argument("--pts", type=int, default=8192)
    ap.add_argument("--obs-per-cam", type=int, default=2048)
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from ms_slam.utils import runtime
    runtime.setup_compile_cache()
    for line in runtime.device_banner():
        print(f"# {line}", flush=True)

    from ms_slam.ops import cameras, lie
    from ms_slam.parallel import dist_ba

    rng = np.random.default_rng(0)
    C, P = args.cams, args.pts
    PIN = cameras.pad_params([400.0, 400.0, 320.0, 240.0])
    BF = 60.0

    # cameras on an arc, points in front
    X = rng.uniform(-8, 8, (P, 3)).astype(np.float32)
    X[:, 2] += 20.0
    Rs = np.zeros((C, 3, 3), np.float32)
    ts = np.zeros((C, 3), np.float32)
    for c in range(C):
        xi = np.array([0.02 * c, 0.001 * c, 0.0005 * c,
                       0.0002 * c, 0.0006 * c, -0.0002 * c], np.float32)
        R, t = lie.se3_exp(jnp.asarray(xi))
        Rs[c], ts[c] = np.asarray(R), np.asarray(t)

    F = C * args.obs_per_cam
    f_cam = np.repeat(np.arange(C, dtype=np.int32), args.obs_per_cam)
    f_pt = rng.integers(0, P, F).astype(np.int32)
    Xc = np.einsum("fij,fj->fi", Rs[f_cam], X[f_pt]) + ts[f_cam]
    z = np.maximum(Xc[:, 2], 1e-3)
    uv = np.stack([400.0 * Xc[:, 0] / z + 320.0,
                   400.0 * Xc[:, 1] / z + 240.0], -1).astype(np.float32)
    uv += rng.normal(0, 0.3, uv.shape).astype(np.float32)
    f_ur = (uv[:, 0] - BF / z).astype(np.float32)
    f_s2 = np.ones(F, np.float32)
    f_valid = np.ones(F, bool)

    cam_opt = np.ones(C, bool)
    cam_opt[0] = False
    Rp = Rs.copy()
    tp = ts + np.concatenate(
        [np.zeros((1, 3)), rng.normal(0, 0.03, (C - 1, 3))]).astype(
        np.float32)
    Xp = (X + rng.normal(0, 0.02, X.shape)).astype(np.float32)

    results = {}
    n_dev = len(jax.devices())
    for D in [d for d in (1, 2, 4, 8) if d <= n_dev]:
        mesh = dist_ba.make_mesh(D)
        run = lambda: jax.block_until_ready(dist_ba.dist_ba_solve(
            mesh, cameras.PINHOLE, PIN, jnp.asarray(BF),
            jnp.asarray(Rp), jnp.asarray(tp), jnp.asarray(cam_opt),
            jnp.asarray(Xp), jnp.ones(P, bool),
            jnp.asarray(f_cam), jnp.asarray(f_pt), jnp.asarray(uv),
            jnp.asarray(f_ur), jnp.asarray(f_s2), jnp.asarray(f_valid),
            n_iters=args.iters))
        run()                     # compile
        best = min(
            (lambda t0: (run(), time.perf_counter() - t0)[1])(
                time.perf_counter())
            for _ in range(args.reps))
        results[D] = round(best, 3)

    out = {
        "metric": "dist_ba_wall_s",
        "cams": C, "pts": P, "factors": F, "gn_iters": args.iters,
        "wall_s_by_devices": results,
        "speedup_vs_1": {D: round(results[1] / w, 2)
                         for D, w in results.items()},
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
