"""YAML settings parsing.

Replaces Settings (/root/reference/src/Settings.cc:144-177 new-format
parser) and the legacy Tracking::Parse*ParamFile readers
(src/Tracking.cc:619,1217,1301), plus the Sparsification.* keys the
reference reads raw in the MapSparsification ctor
(src/MapSparsification.cc:8-12) and System (src/System.cc:162).

Accepts both schema generations: legacy flat keys (Camera.fx) and the
File.version "1.0" sections (Camera1.fx). Unknown keys are ignored; missing
required keys raise with the key name (the reference exits hard on these).
"""
from __future__ import annotations

import re
from typing import Any

import numpy as np

from ..models.map_state import MapConfig
from ..ops import cameras
from ..ops.orb import OrbConfig
from ..pipeline.frontend import Calib
from ..pipeline.system import SystemConfig


_INT = re.compile(r"[-+]?[0-9]+$")
_FLOAT = re.compile(r"[-+]?([0-9]+\.[0-9]*|\.[0-9]+|[0-9]+)([eE][-+]?[0-9]+)?$")


def _strip_comment(line: str) -> str:
    """Drop a '#' comment that is not inside quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch == "#":
            return line[:i]
    return line


def _scalar(tok: str):
    tok = tok.strip()
    if len(tok) >= 2 and tok[0] == tok[-1] and tok[0] in "\"'":
        return tok[1:-1]
    if _INT.match(tok):
        return int(tok)
    if _FLOAT.match(tok):
        return float(tok)
    return tok


def parse_opencv_yaml(text: str) -> dict:
    """The OpenCV-FileStorage subset of YAML that settings files use: an
    optional `%YAML:1.0` / `---` header, `# comments`, `key: scalar` with
    quoted strings, `[ ... ]` lists that may span lines, and nested blocks
    by indentation such as `!!opencv-matrix` (rows / cols / dt / data).
    Returns nested dicts; a key with neither value nor block maps to None."""
    root: dict = {}
    stack = [(-1, root)]                      # (indent, mapping)
    lines = text.splitlines()
    i = 0
    while i < len(lines):
        line = _strip_comment(lines[i]).rstrip()
        i += 1
        body = line.strip()
        if not body or body == "---" or body.startswith("%"):
            continue
        indent = len(line) - len(line.lstrip())
        key, sep, val = body.partition(":")
        if not sep:
            raise ValueError(f"settings line {i}: expected 'key: value', "
                             f"got {body!r}")
        key, val = key.strip(), val.strip()
        while stack[-1][0] >= indent:
            stack.pop()
        node = stack[-1][1]
        if val.startswith("["):
            while "]" not in val:
                if i >= len(lines):
                    raise ValueError(f"settings: unterminated list at {key}")
                val += " " + _strip_comment(lines[i]).strip()
                i += 1
            items = val[1:val.index("]")].split(",")
            node[key] = [_scalar(t) for t in items if t.strip()]
        elif not val or val.startswith("!!"):
            node[key] = {}
            stack.append((indent, node[key]))
        else:
            node[key] = _scalar(val)

    def empty_to_none(d):
        for k, v in d.items():
            if isinstance(v, dict):
                d[k] = empty_to_none(v) if v else None
        return d
    return empty_to_none(root)


def _load_yaml(path: str) -> dict:
    with open(path) as f:
        return parse_opencv_yaml(f.read())


class Settings:
    """Typed reader over the flattened key space."""

    def __init__(self, path: str):
        self.raw = _load_yaml(path)
        self.flat: dict[str, Any] = {}
        self._flatten("", self.raw)

    def _flatten(self, prefix: str, node):
        if isinstance(node, dict):
            for k, v in node.items():
                key = f"{prefix}.{k}" if prefix else str(k)
                self._flatten(key, v)
        else:
            self.flat[prefix] = node

    def get(self, *names, default=None, required=False):
        for n in names:
            if n in self.flat and self.flat[n] is not None:
                return self.flat[n]
        if required:
            raise KeyError(f"missing required setting (any of): {names}")
        return default

    # ------------------------------------------------------------------

    def calib(self) -> Calib:
        g = self.get
        cam_type = str(g("Camera.type", "Camera1.type", default="PinHole"))
        fx = float(g("Camera.fx", "Camera1.fx", required=True))
        fy = float(g("Camera.fy", "Camera1.fy", required=True))
        cx = float(g("Camera.cx", "Camera1.cx", required=True))
        cy = float(g("Camera.cy", "Camera1.cy", required=True))
        if cam_type.lower() in ("kannalabrandt8", "fisheye"):
            params = (fx, fy, cx, cy,
                      float(g("Camera.k1", "Camera1.k1", default=0.0)),
                      float(g("Camera.k2", "Camera1.k2", default=0.0)),
                      float(g("Camera.k3", "Camera1.k3", default=0.0)),
                      float(g("Camera.k4", "Camera1.k4", default=0.0)))
            model = cameras.KB8
        else:
            params = (fx, fy, cx, cy)
            model = cameras.PINHOLE
        width = int(g("Camera.width", "Camera.cols", default=0) or 0)
        height = int(g("Camera.height", "Camera.rows", default=0) or 0)
        bf = float(g("Camera.bf", "Stereo.b", default=0.0) or 0.0)
        if "Stereo.b" in self.flat and "Camera.bf" not in self.flat:
            bf = float(self.flat["Stereo.b"]) * fx
        th_depth = float(g("ThDepth", "Camera.ThDepth", "Stereo.ThDepth",
                           default=35.0))
        fps = float(g("Camera.fps", default=10.0) or 10.0)
        # ThDepth is in units of baseline (ref: mThDepth = mbf*ThDepth/fx)
        th_depth_m = bf * th_depth / fx if bf > 0 else 1e9
        # stereo-fisheye second camera (ref Settings::readCamera2 +
        # Stereo.T_c1_c2 + Camera1/2.overlappingBegin/End,
        # src/Settings.cc:263-333): two unrectified KB8 cameras
        params2: tuple = ()
        T_rl: tuple = ()
        lapping: tuple = ()
        if model == cameras.KB8 and "Camera2.fx" in self.flat:
            params2 = (float(g("Camera2.fx")), float(g("Camera2.fy")),
                       float(g("Camera2.cx")), float(g("Camera2.cy")),
                       float(g("Camera2.k1", default=0.0)),
                       float(g("Camera2.k2", default=0.0)),
                       float(g("Camera2.k3", default=0.0)),
                       float(g("Camera2.k4", default=0.0)))
            import numpy as np
            T12 = np.asarray(g("Stereo.T_c1_c2.data",
                               "Stereo.T_c1_c2", required=True),
                             np.float64).reshape(-1)[:16].reshape(4, 4)
            # T_c1_c2 maps cam2 coords into cam1 coords; the frontend
            # wants right-from-left = its inverse
            T21 = np.linalg.inv(T12)
            T_rl = tuple(float(v) for v in T21[:3, :4].reshape(-1))
            lapping = (int(g("Camera1.overlappingBegin", default=0)),
                       int(g("Camera1.overlappingEnd",
                             default=width or 10 ** 6)),
                       int(g("Camera2.overlappingBegin", default=0)),
                       int(g("Camera2.overlappingEnd",
                             default=width or 10 ** 6)))
            if bf <= 0:
                bf = float(np.linalg.norm(T12[:3, 3])) * fx
        return Calib(model=model, params=params, bf=bf, width=width,
                     height=height, th_depth=th_depth_m, fps=fps,
                     params2=params2, T_rl=T_rl, lapping=lapping)

    def orb(self, n_feat_cap: int | None = None) -> OrbConfig:
        g = self.get
        n = int(g("ORBextractor.nFeatures", default=2000))
        if n_feat_cap:
            n = min(n, n_feat_cap)
        # round up to a multiple of 128: the deployment's feature
        # capacity, and with it every per-frame shape, is fixed by this
        n = -(-n // 128) * 128
        return OrbConfig(
            n_features=n,
            n_levels=int(g("ORBextractor.nLevels", default=8)),
            scale_factor=float(g("ORBextractor.scaleFactor", default=1.2)),
            ini_th=float(g("ORBextractor.iniThFAST", default=20)),
            min_th=float(g("ORBextractor.minThFAST", default=7)),
        )

    def system_config(self, max_kf: int = 512, max_mp: int = 65536,
                      local_cap: int = 8192) -> SystemConfig:
        g = self.get
        calib = self.calib()
        orb = self.orb()
        mcfg = MapConfig(max_kf=max_kf, max_mp=max_mp,
                         n_feat=orb.n_features, local_mp_cap=local_cap,
                         window_kf=8)
        # IMU block (ref Settings::readIMU; presence of the noise keys
        # marks an inertial configuration)
        has_imu = g("IMU.NoiseGyro") is not None
        Tbc = g("IMU.T_b_c1", "IMU.T_b_c1.data", "Tbc", "Tbc.data")
        if Tbc is not None:
            Tbc = np.asarray(Tbc, np.float64).reshape(4, 4)
        return SystemConfig(
            calib=calib, orb=orb, map=mcfg,
            max_frames_between_kf=int(round(calib.fps)),
            sparsify=g("Sparsification.N") is not None,
            sparsify_n=int(g("Sparsification.N", default=75)),
            sparsify_lambda=float(g("Sparsification.Lambda", default=500)),
            sparsify_grid_lambda=float(
                g("Sparsification.GridLambda", default=10)),
            sparsify_window=int(g("Sparsification.WindowLength", default=30)),
            nonlocal_kf=int(g("Sparsification.NonLocalKF", default=30)),
            loop_closing=bool(int(g("loopClosing", default=1))),
            use_imu=has_imu,
            imu_noise_gyro=float(g("IMU.NoiseGyro", default=1e-3)),
            imu_noise_acc=float(g("IMU.NoiseAcc", default=1e-2)),
            imu_gyro_walk=float(g("IMU.GyroWalk", default=1e-6)),
            imu_acc_walk=float(g("IMU.AccWalk", default=1e-4)),
            Tbc=Tbc,
        )
