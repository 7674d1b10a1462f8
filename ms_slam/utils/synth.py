"""Synthetic stereo world renderer for integration tests and benchmarks.

The reference has no test suite (SURVEY §4); we build deterministic
rendered worlds instead: textured axis-aligned planes ray-cast per pixel,
so a full stereo sequence with exact ground-truth trajectory is available
anywhere (CPU tests, GPU benchmarks) without dataset downloads.
"""
from __future__ import annotations

import numpy as np


def mondrian_texture(rng, size=768, n_rects=400):
    tex = np.full((size, size), 128.0, np.float32)
    for _ in range(n_rects):
        y0, x0 = rng.integers(0, size - 8, 2)
        h, w = rng.integers(8, size // 6, 2)
        tex[y0:y0 + h, x0:x0 + w] = rng.uniform(15, 240)
    return tex


class PlaneWorld:
    """Two textured planes: wall at z=z_wall, floor at y=y_floor (world
    frame: x right, y down, z forward — camera convention)."""

    def __init__(self, rng, z_wall=14.0, y_floor=2.0, tex_scale=0.02):
        self.z_wall = z_wall
        self.y_floor = y_floor
        self.tex_wall = mondrian_texture(rng)
        self.tex_floor = mondrian_texture(rng)
        self.tex_scale = tex_scale  # world units per texel

    def _sample(self, tex, a, b):
        size = tex.shape[0]
        ia = (a / self.tex_scale) % size
        ib = (b / self.tex_scale) % size
        i0 = np.floor(ia).astype(int) % size
        j0 = np.floor(ib).astype(int) % size
        i1 = (i0 + 1) % size
        j1 = (j0 + 1) % size
        fa = ia - np.floor(ia)
        fb = ib - np.floor(ib)
        return (tex[i0, j0] * (1 - fa) * (1 - fb) + tex[i1, j0] * fa * (1 - fb)
                + tex[i0, j1] * (1 - fa) * fb + tex[i1, j1] * fa * fb)

    def render(self, K: np.ndarray, T_wc: np.ndarray, h: int, w: int):
        """Render the view from camera-to-world pose T_wc (4,4)."""
        Rwc = T_wc[:3, :3]
        Ow = T_wc[:3, 3]
        us, vs = np.meshgrid(np.arange(w), np.arange(h))
        rays_c = np.stack([(us - K[0, 2]) / K[0, 0],
                           (vs - K[1, 2]) / K[1, 1],
                           np.ones_like(us, np.float64)], axis=-1)
        d = rays_c @ Rwc.T  # (h,w,3) world directions

        img = np.zeros((h, w), np.float32)
        depth = np.full((h, w), np.inf)

        # wall z = z_wall
        dz = d[..., 2]
        dz_s = np.where(np.abs(dz) > 1e-9, dz, 1e-9)
        t_wall = np.where(np.abs(dz) > 1e-9, (self.z_wall - Ow[2]) / dz_s, -1)
        ok = t_wall > 0.1
        Xw = Ow[None, None, :] + t_wall[..., None] * d
        val = self._sample(self.tex_wall, Xw[..., 0], Xw[..., 1])
        use = ok & (t_wall < depth)
        img = np.where(use, val, img)
        depth = np.where(use, t_wall, depth)

        # floor y = y_floor
        dy = d[..., 1]
        dy_s = np.where(np.abs(dy) > 1e-9, dy, 1e-9)
        t_fl = np.where(np.abs(dy) > 1e-9, (self.y_floor - Ow[1]) / dy_s, -1)
        ok = t_fl > 0.1
        Xf = Ow[None, None, :] + t_fl[..., None] * d
        val = self._sample(self.tex_floor, Xf[..., 0], Xf[..., 2])
        use = ok & (t_fl < depth)
        img = np.where(use, val, img)
        depth = np.where(use, t_fl, depth)
        return img.astype(np.float32)

    def render_stereo(self, K, T_wc, baseline, h, w):
        T_right = T_wc.copy()
        # right camera displaced +x in camera frame
        T_right[:3, 3] = T_wc[:3, 3] + T_wc[:3, :3] @ np.array([baseline, 0, 0])
        return self.render(K, T_wc, h, w), self.render(K, T_right, h, w)

    def render_rgbd(self, K, T_wc, h, w):
        """(gray, depth[m]) pair for the RGB-D frontend."""
        img = self.render(K, T_wc, h, w)
        # recompute depth (z in camera frame = ray depth * dir_z)
        Rwc = T_wc[:3, :3]
        Ow = T_wc[:3, 3]
        us, vs = np.meshgrid(np.arange(w), np.arange(h))
        rays_c = np.stack([(us - K[0, 2]) / K[0, 0],
                           (vs - K[1, 2]) / K[1, 1],
                           np.ones_like(us, np.float64)], axis=-1)
        d = rays_c @ Rwc.T
        depth = np.full((h, w), 0.0)
        best_t = np.full((h, w), np.inf)
        for ax, val in ((2, self.z_wall), (1, self.y_floor)):
            da = d[..., ax]
            da_s = np.where(np.abs(da) > 1e-9, da, 1e-9)
            t = np.where(np.abs(da) > 1e-9, (val - Ow[ax]) / da_s, -1)
            ok = (t > 0.1) & (t < best_t)
            # camera-frame z = t * (ray_c z) = t (rays have z=1 pre-rotation)
            depth = np.where(ok, t, depth)
            best_t = np.where(ok, t, best_t)
        return img, depth.astype(np.float32)


class BoxWorld:
    """Closed textured room: 4 walls + floor + ceiling, for loop-closure
    sequences (every viewing direction sees texture)."""

    def __init__(self, rng, half=6.0, y_floor=2.0, y_ceil=-3.0,
                 tex_scale=0.02):
        self.half = half
        self.y_floor = y_floor
        self.y_ceil = y_ceil
        self.tex = [mondrian_texture(rng) for _ in range(6)]
        self.tex_scale = tex_scale

    def _sample(self, tex, a, b):
        return PlaneWorld._sample(self, tex, a, b)

    def render(self, K, T_wc, h, w):
        Rwc = T_wc[:3, :3]
        Ow = T_wc[:3, 3]
        us, vs = np.meshgrid(np.arange(w), np.arange(h))
        rays_c = np.stack([(us - K[0, 2]) / K[0, 0],
                           (vs - K[1, 2]) / K[1, 1],
                           np.ones_like(us, np.float64)], axis=-1)
        d = rays_c @ Rwc.T
        img = np.zeros((h, w), np.float32)
        depth = np.full((h, w), np.inf)
        # planes: (axis, value, texture, (tex axes))
        planes = [(0, self.half, self.tex[0], (1, 2)),
                  (0, -self.half, self.tex[1], (1, 2)),
                  (2, self.half, self.tex[2], (0, 1)),
                  (2, -self.half, self.tex[3], (0, 1)),
                  (1, self.y_floor, self.tex[4], (0, 2)),
                  (1, self.y_ceil, self.tex[5], (0, 2))]
        for ax, val, tex, (a_ax, b_ax) in planes:
            da = d[..., ax]
            da_s = np.where(np.abs(da) > 1e-9, da, 1e-9)
            t = np.where(np.abs(da) > 1e-9, (val - Ow[ax]) / da_s, -1)
            ok = (t > 0.1) & (t < depth)
            X = Ow[None, None, :] + t[..., None] * d
            val_img = self._sample(tex, X[..., a_ax], X[..., b_ax])
            img = np.where(ok, val_img, img)
            depth = np.where(ok, t, depth)
        return img.astype(np.float32)

    def render_stereo(self, K, T_wc, baseline, h, w):
        T_right = T_wc.copy()
        T_right[:3, 3] = T_wc[:3, 3] + T_wc[:3, :3] @ np.array([baseline, 0, 0])
        return self.render(K, T_wc, h, w), self.render(K, T_right, h, w)

    def iter_planes(self):
        return [(0, self.half, self.tex[0], (1, 2)),
                (0, -self.half, self.tex[1], (1, 2)),
                (2, self.half, self.tex[2], (0, 1)),
                (2, -self.half, self.tex[3], (0, 1)),
                (1, self.y_floor, self.tex[4], (0, 2)),
                (1, self.y_ceil, self.tex[5], (0, 2))]

    def render_fisheye_stereo(self, kb8_params, T_wc, baseline, h, w,
                              kb8_params2=None):
        """Unrectified fisheye pair: right camera displaced +x in the
        left camera frame (pure-translation rig)."""
        rays_l = kb8_rays(kb8_params, h, w)
        rays_r = kb8_rays(kb8_params2 or kb8_params, h, w)
        T_right = T_wc.copy()
        T_right[:3, 3] = T_wc[:3, 3] + T_wc[:3, :3] @ np.array(
            [baseline, 0, 0])
        return (render_rays(self, rays_l, T_wc),
                render_rays(self, rays_r, T_right))


class CorridorWorld:
    """Infinite textured corridor along +z: side walls at x=+-half_w, floor
    and ceiling — close stereo geometry along an arbitrarily long forward
    run (KITTI-street analog for long-sequence tests)."""

    def __init__(self, rng, half_w=3.0, y_floor=1.6, y_ceil=-2.2,
                 tex_scale=0.05, tex_size=4096):
        self.half_w = half_w
        self.y_floor = y_floor
        self.y_ceil = y_ceil
        # big texture: the sampler tiles with period tex_size * tex_scale
        # (204.8 m at the defaults) — long forward runs must NOT revisit
        # identical wall appearance, or place recognition correctly
        # "closes" a loop on the exact repeat (perceptual aliasing by
        # construction, which no appearance-based system can reject)
        self.tex = [mondrian_texture(rng, size=tex_size,
                                     n_rects=400 * (tex_size // 768) ** 2)
                    for _ in range(4)]
        self.tex_scale = tex_scale

    def _sample(self, tex, a, b):
        return PlaneWorld._sample(self, tex, a, b)

    def render(self, K, T_wc, h, w):
        Rwc = T_wc[:3, :3]
        Ow = T_wc[:3, 3]
        us, vs = np.meshgrid(np.arange(w), np.arange(h))
        rays_c = np.stack([(us - K[0, 2]) / K[0, 0],
                           (vs - K[1, 2]) / K[1, 1],
                           np.ones_like(us, np.float64)], axis=-1)
        d = rays_c @ Rwc.T
        img = np.zeros((h, w), np.float32)
        depth = np.full((h, w), np.inf)
        planes = [(0, self.half_w, self.tex[0], (1, 2)),
                  (0, -self.half_w, self.tex[1], (1, 2)),
                  (1, self.y_floor, self.tex[2], (0, 2)),
                  (1, self.y_ceil, self.tex[3], (0, 2))]
        for ax, val, tex, (a_ax, b_ax) in planes:
            da = d[..., ax]
            da_s = np.where(np.abs(da) > 1e-9, da, 1e-9)
            t = np.where(np.abs(da) > 1e-9, (val - Ow[ax]) / da_s, -1)
            ok = (t > 0.1) & (t < depth)
            X = Ow[None, None, :] + t[..., None] * d
            val_img = self._sample(tex, X[..., a_ax], X[..., b_ax])
            img = np.where(ok, val_img, img)
            depth = np.where(ok, t, depth)
        return img.astype(np.float32)

    def render_stereo(self, K, T_wc, baseline, h, w):
        T_right = T_wc.copy()
        T_right[:3, 3] = T_wc[:3, 3] + T_wc[:3, :3] @ np.array(
            [baseline, 0, 0])
        return self.render(K, T_wc, h, w), self.render(K, T_right, h, w)


def kb8_rays(params, h: int, w: int):
    """(h,w,3) z=1 bearings for a Kannala-Brandt8 camera (numpy Newton
    inversion of the equidistant distortion — the renderer-side analog of
    ops.cameras.kb8_unproject)."""
    fx, fy, cx, cy, k0, k1, k2, k3 = params
    us, vs = np.meshgrid(np.arange(w), np.arange(h))
    mx = (us - cx) / fx
    my = (vs - cy) / fy
    theta_d = np.sqrt(mx * mx + my * my)
    th = np.clip(theta_d, 0, np.pi / 2)
    for _ in range(10):
        t2 = th * th
        f = th * (1 + t2 * (k0 + t2 * (k1 + t2 * (k2 + t2 * k3)))) - theta_d
        df = 1 + t2 * (3 * k0 + t2 * (5 * k1 + t2 * (7 * k2 + 9 * t2 * k3)))
        th = th - f / np.where(np.abs(df) > 1e-8, df, 1.0)
    scale = np.where(theta_d > 1e-8, np.tan(th) / np.maximum(theta_d, 1e-8),
                     1.0)
    return np.stack([mx * scale, my * scale, np.ones_like(mx)], -1)


def render_rays(world, rays_c, T_wc):
    """Render any of the plane worlds through arbitrary per-pixel rays
    (fisheye support). world must expose the same plane list logic as
    BoxWorld/CorridorWorld via `iter_planes()`."""
    Rwc = T_wc[:3, :3]
    Ow = T_wc[:3, 3]
    d = rays_c @ Rwc.T
    h, w = rays_c.shape[:2]
    img = np.zeros((h, w), np.float32)
    depth = np.full((h, w), np.inf)
    for ax, val, tex, (a_ax, b_ax) in world.iter_planes():
        da = d[..., ax]
        da_s = np.where(np.abs(da) > 1e-9, da, 1e-9)
        t = np.where(np.abs(da) > 1e-9, (val - Ow[ax]) / da_s, -1)
        ok = (t > 0.1) & (t < depth)
        X = Ow[None, None, :] + t[..., None] * d
        v = world._sample(tex, X[..., a_ax], X[..., b_ax])
        img = np.where(ok, v, img)
        depth = np.where(ok, t, depth)
    return img.astype(np.float32)


def make_imu(poses, frame_dt: float, imu_rate: int = 20, g=9.81):
    """Synthesize body-frame IMU samples along a pose sequence.

    poses: list of T_wc (camera==body). Returns per-frame-interval arrays
    [(M,7) rows (dt, ax,ay,az, gx,gy,gz)] with gravity [0,0,-g] in world
    (camera convention: y down => world -y is up, so g_world = (0,+g,0)?
    We use the SLAM camera frame: x right, y down, z forward; gravity pulls
    along +y in a level world)."""
    from scipy.interpolate import CubicSpline
    from scipy.spatial.transform import Rotation, Slerp
    n = len(poses)
    ts = np.arange(n) * frame_dt
    ps = np.stack([T[:3, 3] for T in poses])
    Rs = Rotation.from_matrix(np.stack([T[:3, :3] for T in poses]))
    pos_sp = CubicSpline(ts, ps)
    slerp = Slerp(ts, Rs)
    g_w = np.array([0.0, g, 0.0])  # y-down camera/world convention

    out = []
    sub = max(int(round(imu_rate * frame_dt)), 2)
    for i in range(1, n):
        rows = []
        tt = np.linspace(ts[i - 1], ts[i], sub + 1)
        dt = tt[1] - tt[0]
        for k in range(sub):
            t = tt[k]
            tm = np.clip(t, ts[0] + 1e-6, ts[-1] - 1e-6)
            a_w = pos_sp(tm, 2)
            R = slerp([tm])[0].as_matrix()
            # gyro from relative rotation over dt
            t2 = np.clip(tm + dt, ts[0] + 1e-6, ts[-1] - 1e-6)
            R2 = slerp([t2])[0].as_matrix()
            dRot = Rotation.from_matrix(R.T @ R2).as_rotvec()
            omega = dRot / dt
            # specific force: f = R^T (a_w - g_vec); at rest this reads
            # (0,-g,0) in a level y-down body frame
            acc_body = R.T @ (a_w - g_w)
            rows.append([dt, *acc_body, *omega])
        out.append(np.asarray(rows))
    return out


def make_trajectory(n_frames: int, pattern: str = "arc"):
    """Ground-truth camera-to-world poses."""
    from scipy.spatial.transform import Rotation
    poses = []
    for i in range(n_frames):
        T = np.eye(4)
        if pattern == "arc":
            s = i / max(n_frames - 1, 1)
            T[:3, 3] = [2.5 * s, 0.3 * np.sin(2 * np.pi * s), 1.5 * s]
            yaw = 0.25 * np.sin(2 * np.pi * s)
            T[:3, :3] = Rotation.from_euler("y", yaw).as_matrix()
        elif pattern == "arc_excited":
            # arc + ~1 Hz accelerometer excitation (IMU-observability:
            # the reference refuses inertial init below 0.5 m/s^2 of
            # acceleration variation, src/Tracking.cc:2333-2337 — the
            # plain arc peaks at ~0.25; this adds ~3-5 m/s^2 without
            # meaningfully moving the image, assuming 10 fps frames)
            s = i / max(n_frames - 1, 1)
            t = 0.1 * i
            T[:3, 3] = [2.5 * s + 0.08 * np.sin(2 * np.pi * 0.8 * t + 1.0),
                        0.3 * np.sin(2 * np.pi * s)
                        + 0.12 * np.sin(2 * np.pi * t),
                        1.5 * s]
            yaw = 0.25 * np.sin(2 * np.pi * s)
            T[:3, :3] = Rotation.from_euler("y", yaw).as_matrix()
        elif pattern == "forward":
            T[:3, 3] = [0, 0, 0.12 * i]
        elif pattern == "orbit":
            # full in-place yaw loop with a small circular translation:
            # ends where it started => loop-closure opportunity
            a = 2 * np.pi * i / n_frames
            T[:3, :3] = Rotation.from_euler("y", a).as_matrix()
            T[:3, 3] = [0.8 * np.sin(a), 0.0, 0.8 * (1 - np.cos(a))]
        poses.append(T)
    return poses
