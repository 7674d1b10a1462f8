"""Jitted stereo frame processing front end.

Replaces the Frame constructor pipeline of the reference
(/root/reference/src/Frame.cc: dual-thread ORB extraction :122-124,
undistortion, grid assignment, ComputeStereoMatches :169): here one fused
jit takes the rectified pair and returns features + stereo depth on device.
The reference's left/right thread parallelism becomes batched kernels; the
64x48 feature grid is unnecessary (matching is an all-pairs matmul).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import orb, stereo


class Calib(NamedTuple):
    """Static camera calibration (hashable -> jit static argument).

    Mirrors Settings' camera section (/root/reference/src/Settings.cc:144-:
    fx fy cx cy, stereo bf, depth threshold). For unrectified stereo-
    fisheye (two KannalaBrandt8 cameras, ref Frame fisheye ctor with
    Nleft/Nright + KannalaBrandt8::mvLappingArea), params2/T_rl/lapping
    describe the second camera: T_rl maps LEFT-camera coords into
    RIGHT-camera coords (12 floats, row-major [R|t] — ref
    Stereo.T_c1_c2 inverse), lapping = (x0_l, x1_l, x0_r, x1_r) pixel
    columns (ref Camera1/2.overlappingBegin/End,
    src/Settings.cc:263-333)."""

    model: int              # cameras.PINHOLE / cameras.KB8
    params: tuple           # up to 8 floats (fx, fy, cx, cy, k0..k3)
    bf: float               # baseline * fx
    width: int
    height: int
    th_depth: float = 35.0  # close/far stereo point threshold (ref ThDepth)
    fps: float = 10.0
    params2: tuple = ()     # right-camera intrinsics (fisheye stereo)
    T_rl: tuple = ()        # right-from-left extrinsic, 12 floats
    lapping: tuple = ()     # (x0_l, x1_l, x0_r, x1_r)

    def params_array(self):
        import numpy as np
        p = np.zeros(8, np.float32)
        p[:len(self.params)] = self.params
        return jnp.asarray(p)

    def params2_array(self):
        import numpy as np
        p = np.zeros(8, np.float32)
        src = self.params2 if self.params2 else self.params
        p[:len(src)] = src
        return jnp.asarray(p)

    @property
    def is_fisheye_stereo(self) -> bool:
        return len(self.T_rl) == 12

    @property
    def min_z(self) -> float:
        # minimum triangulable depth ~ baseline (ref mb = mbf/fx)
        return max(self.bf / self.params[0], 0.1)


class FrameData(NamedTuple):
    """Device-resident per-frame working state (ref Frame object)."""

    feats: orb.Features
    u_right: jnp.ndarray   # (N,)
    depth: jnp.ndarray     # (N,)
    sigma2: jnp.ndarray    # (N,) per-octave measurement variance


@partial(jax.jit, static_argnames=("calib", "orb_cfg"))
def process_stereo_stacked(imgs: jnp.ndarray, calib: Calib,
                           orb_cfg: orb.OrbConfig) -> FrameData:
    """Stereo frontend taking a stacked (2,H,W) uint8 pair — one
    host->device transfer for the pair."""
    return _process_stereo_impl(imgs[0], imgs[1], calib, orb_cfg)


@partial(jax.jit, static_argnames=("calib", "orb_cfg"))
def process_stereo(img_l: jnp.ndarray, img_r: jnp.ndarray,
                   calib: Calib, orb_cfg: orb.OrbConfig) -> FrameData:
    """Extract ORB on both images and stereo-match (the per-frame hot path
    ahead of tracking)."""
    return _process_stereo_impl(img_l, img_r, calib, orb_cfg)


def _process_stereo_impl(img_l, img_r, calib: Calib,
                         orb_cfg: orb.OrbConfig) -> FrameData:
    # images arrive uint8 (4x less host->device transfer) and are cast on
    # device; BOTH images extract on canvas-packed pyramids in one batch
    imgs = jnp.stack([img_l, img_r]).astype(jnp.float32)
    featsB, canvases = orb.extract_canvas_multi(imgs, orb_cfg)
    feats_l = jax.tree.map(lambda a: a[0], featsB)
    feats_r = jax.tree.map(lambda a: a[1], featsB)
    sm = stereo.match_stereo_canvas(feats_l, feats_r, canvases[0],
                                    canvases[1], imgs.shape[2],
                                    calib.bf, calib.min_z, orb_cfg)
    scale2 = jnp.asarray(
        [s * s for s in orb_cfg.level_scales()], dtype=jnp.float32)
    sigma2 = scale2[feats_l.octave]
    return FrameData(feats=feats_l, u_right=sm.u_right, depth=sm.depth,
                     sigma2=sigma2)


@partial(jax.jit, static_argnames=("calib", "orb_cfg"))
def process_stereo_fisheye(imgs: jnp.ndarray, calib: Calib,
                           orb_cfg: orb.OrbConfig) -> FrameData:
    """Unrectified stereo-fisheye frontend (two KannalaBrandt8 cameras):
    ORB on both full images, mutual descriptor matching restricted to the
    lapping areas, and KB8 two-view triangulation of the matches — the
    Batched counterpart of Frame::ComputeStereoFishEyeMatches +
    KannalaBrandt8::matchAndtriangulate
    (/root/reference/src/Frame.cc fisheye ctor,
    src/CameraModels/KannalaBrandt8.cpp). Matched features get a
    triangulated left-camera depth; u_right stays -1 (there is no
    rectified right coordinate — downstream stereo residuals apply only
    to rectified rigs, matching the reference's separate fisheye
    handling)."""
    from ..ops import cameras, matching, triangulate

    imgs_f = imgs.astype(jnp.float32)
    featsB, _ = orb.extract_canvas_multi(imgs_f, orb_cfg)
    f_l = jax.tree.map(lambda a: a[0], featsB)
    f_r = jax.tree.map(lambda a: a[1], featsB)

    x0l, x1l, x0r, x1r = (calib.lapping if len(calib.lapping) == 4
                          else (0, calib.width, 0, calib.width))
    lap_l = (f_l.xy[:, 0] >= x0l) & (f_l.xy[:, 0] <= x1l)
    lap_r = (f_r.xy[:, 0] >= x0r) & (f_r.xy[:, 0] <= x1r)
    mm = matching.mutual_match(
        f_l.desc, f_l.valid & lap_l, f_r.desc, f_r.valid & lap_r,
        max_dist=matching.TH_LOW, nn_ratio=0.9,
        angle_a=f_l.angle, angle_b=f_r.angle)
    has = mm.idx_b >= 0
    ib = jnp.clip(mm.idx_b, 0)

    # KB8 triangulation in the left camera frame
    T = jnp.asarray(calib.T_rl, jnp.float32).reshape(3, 4)
    R_rl, t_rl = T[:, :3], T[:, 3]
    p1 = calib.params_array()
    p2 = calib.params2_array()
    b_l = cameras.kb8_unproject(p1, f_l.xy)
    b_r = cameras.kb8_unproject(p2, f_r.xy)[ib]
    N = b_l.shape[0]
    P1 = jnp.broadcast_to(
        jnp.concatenate([jnp.eye(3, dtype=jnp.float32),
                         jnp.zeros((3, 1), jnp.float32)], 1), (N, 3, 4))
    P2 = jnp.broadcast_to(T, (N, 3, 4))
    X = triangulate.triangulate_dlt(b_l, b_r, P1, P2)
    scale2 = jnp.asarray(
        [s * s for s in orb_cfg.level_scales()], dtype=jnp.float32)
    s2_l = scale2[f_l.octave]
    s2_r = scale2[f_r.octave][ib]

    # Gauss-Newton polish of each point over BOTH fisheye reprojections
    # (the z=1-bearing DLT minimizes algebraic error, which biases depth
    # several percent at narrow disparity; two 3x3 GN steps recover the
    # ML triangulation the reference gets from its unrectified
    # Triangulate + checks)
    from ..ops import lie as lie_ops
    xy_r = f_r.xy[ib]
    wl = (1.0 / jnp.maximum(s2_l, 1e-9))[:, None, None]
    wr = (1.0 / jnp.maximum(s2_r, 1e-9))[:, None, None]

    def gn_step(X):
        r1 = cameras.kb8_project(p1, X) - f_l.xy
        J1 = cameras.kb8_project_jac(p1, X)
        Xr_ = X @ R_rl.T + t_rl
        r2 = cameras.kb8_project(p2, Xr_) - xy_r
        J2 = jnp.einsum("nij,jk->nik", cameras.kb8_project_jac(p2, Xr_),
                        R_rl)
        Hm = (jnp.einsum("nij,nik->njk", J1 * wl, J1)
              + jnp.einsum("nij,nik->njk", J2 * wr, J2)
              + 1e-6 * jnp.eye(3, dtype=X.dtype))
        g = (jnp.einsum("nij,ni->nj", J1 * wl, r1)
             + jnp.einsum("nij,ni->nj", J2 * wr, r2))
        dX = jnp.einsum("nij,nj->ni", lie_ops.inv3x3(Hm), g)
        return X - dX

    X = gn_step(gn_step(X))
    z_l = X[:, 2]
    Xr = X @ R_rl.T + t_rl
    z_r = Xr[:, 2]
    e_l = jnp.sum((cameras.kb8_project(p1, X) - f_l.xy) ** 2, -1)
    e_r = jnp.sum((cameras.kb8_project(p2, Xr) - f_r.xy[ib]) ** 2, -1)
    min_z = 0.05
    good = (has & (z_l > min_z) & (z_r > min_z)
            & (e_l < 5.991 * s2_l) & (e_r < 5.991 * s2_r))
    depth = jnp.where(good, z_l, -1.0)
    return FrameData(feats=f_l, u_right=jnp.full((N,), -1.0, jnp.float32),
                     depth=depth, sigma2=s2_l)


@partial(jax.jit, static_argnames=("calib", "orb_cfg"))
def process_rgbd(img: jnp.ndarray, depth_map: jnp.ndarray,
                 calib: Calib, orb_cfg: orb.OrbConfig) -> FrameData:
    """RGB-D frame: ORB on the gray image; each keypoint reads its depth
    from the registered depth map and synthesizes a virtual right coordinate
    uR = u - bf/d (ref Frame::ComputeStereoFromRGBD, src/Frame.cc)."""
    img = img.astype(jnp.float32)
    featsB, _ = orb.extract_canvas_multi(img[None], orb_cfg)
    feats = jax.tree.map(lambda a: a[0], featsB)
    h, w = depth_map.shape
    ui = jnp.clip(jnp.round(feats.xy[:, 0]).astype(jnp.int32), 0, w - 1)
    vi = jnp.clip(jnp.round(feats.xy[:, 1]).astype(jnp.int32), 0, h - 1)
    d = depth_map[vi, ui]
    ok = (d > 0.05) & feats.valid
    depth = jnp.where(ok, d, -1.0)
    u_right = jnp.where(ok, feats.xy[:, 0] - calib.bf / jnp.maximum(d, 1e-6),
                        -1.0)
    scale2 = jnp.asarray(
        [s * s for s in orb_cfg.level_scales()], dtype=jnp.float32)
    return FrameData(feats=feats, u_right=u_right, depth=depth,
                     sigma2=scale2[feats.octave])


@partial(jax.jit, static_argnames=("calib", "orb_cfg"))
def process_mono(img: jnp.ndarray, calib: Calib,
                 orb_cfg: orb.OrbConfig) -> FrameData:
    """Monocular frame: features only, no depth (ref the monocular Frame
    ctor, include/Frame.h:70)."""
    img = img.astype(jnp.float32)
    featsB, _ = orb.extract_canvas_multi(img[None], orb_cfg)
    feats = jax.tree.map(lambda a: a[0], featsB)
    n = feats.xy.shape[0]
    scale2 = jnp.asarray(
        [s * s for s in orb_cfg.level_scales()], dtype=jnp.float32)
    return FrameData(feats=feats,
                     u_right=jnp.full((n,), -1.0, jnp.float32),
                     depth=jnp.full((n,), -1.0, jnp.float32),
                     sigma2=scale2[feats.octave])
