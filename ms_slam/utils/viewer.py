"""Headless map visualization.

Replaces the reference's Pangolin Viewer/MapDrawer/FrameDrawer
(/root/reference/src/{Viewer,MapDrawer,FrameDrawer}.cc) with offline
artifacts that keep the same color semantics (src/MapDrawer.cc:110-191):
  - live (unsparsified) map points RED, sparsified-kept points BLUE
  - non-local keyframes BLUE, local (recently in BA window) YELLOW
Outputs: PLY point clouds (any 3D viewer) and matplotlib top-down figures.
An accelerator host has no GL display; dumps are the production observability
surface (plus the structured timing in System.timing, the REGISTER_TIMES
analog)."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class MapSnapshot:
    mp_pos: np.ndarray          # (M,3)
    mp_valid: np.ndarray        # (M,)
    mp_sparsified: np.ndarray
    kf_twc: np.ndarray          # (K,3) camera centers
    kf_valid: np.ndarray
    kf_sparsified: np.ndarray
    trajectory: np.ndarray      # (F,3) per-frame camera centers

    @classmethod
    def from_system(cls, slam) -> "MapSnapshot":
        ms = slam.ms
        R = np.asarray(ms.kf_R)
        t = np.asarray(ms.kf_t)
        centers = -np.einsum("kij,ki->kj", R.transpose(0, 2, 1), t)
        traj = np.asarray([T[:3, 3] for _, T in slam.poses_wc()]
                          or np.zeros((0, 3)))
        return cls(
            mp_pos=np.asarray(ms.mp_pos),
            mp_valid=np.asarray(ms.mp_valid),
            mp_sparsified=np.asarray(ms.mp_sparsified),
            kf_twc=centers,
            kf_valid=np.asarray(ms.kf_valid),
            kf_sparsified=np.asarray(ms.kf_sparsified),
            trajectory=traj.reshape(-1, 3))

    def save_ply(self, path: str):
        """Colored point cloud + keyframe markers (red live / blue kept,
        ref MapDrawer.cc:123-145)."""
        pts, cols = [], []
        for i in np.where(self.mp_valid)[0]:
            pts.append(self.mp_pos[i])
            cols.append((0, 0, 255) if self.mp_sparsified[i] else (255, 0, 0))
        for k in np.where(self.kf_valid)[0]:
            pts.append(self.kf_twc[k])
            cols.append((0, 0, 255) if self.kf_sparsified[k]
                        else (255, 255, 0))
        with open(path, "w") as f:
            f.write("ply\nformat ascii 1.0\n"
                    f"element vertex {len(pts)}\n"
                    "property float x\nproperty float y\nproperty float z\n"
                    "property uchar red\nproperty uchar green\n"
                    "property uchar blue\nend_header\n")
            for p, c in zip(pts, cols):
                f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} "
                        f"{c[0]} {c[1]} {c[2]}\n")

    def plot_topdown(self, path: str, plane=(0, 2)):
        """x-z top-down view: points, keyframes, trajectory."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        a, b = plane
        fig, ax = plt.subplots(figsize=(8, 8))
        live = self.mp_valid & ~self.mp_sparsified
        kept = self.mp_valid & self.mp_sparsified
        ax.scatter(self.mp_pos[live, a], self.mp_pos[live, b], s=1,
                   c="red", label="live points")
        ax.scatter(self.mp_pos[kept, a], self.mp_pos[kept, b], s=1,
                   c="blue", label="sparsified points")
        kf = self.kf_valid
        ax.scatter(self.kf_twc[kf, a], self.kf_twc[kf, b], s=12,
                   c=np.where(self.kf_sparsified[kf], "blue", "gold"),
                   marker="s", label="keyframes")
        if len(self.trajectory):
            ax.plot(self.trajectory[:, a], self.trajectory[:, b],
                    "g-", lw=1, label="trajectory")
        ax.set_aspect("equal")
        ax.legend(loc="upper right", fontsize=8)
        ax.set_title("MS-SLAM map (top-down)")
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)


def draw_frame(image: np.ndarray, kp_xy: np.ndarray, kp_valid: np.ndarray,
               tracked: np.ndarray, path: str, state: str = "OK",
               n_tracked: int | None = None):
    """FrameDrawer analog (/root/reference/src/FrameDrawer.cc): dump the
    current frame with its keypoints overlaid — tracked map-point matches
    GREEN, extracted-but-unmatched features BLUE — plus the status bar
    text (state + match count). Pure-numpy RGB render written as PNG via
    matplotlib (headless)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    im = np.asarray(image)
    if im.ndim == 2:
        rgb = np.repeat(im[..., None], 3, axis=-1).astype(np.float32)
        if rgb.max() > 1.0:
            rgb /= 255.0
    else:
        rgb = im.astype(np.float32)
    h, w = rgb.shape[:2]
    kp = np.asarray(kp_xy)
    v = np.asarray(kp_valid).astype(bool)
    tr = np.asarray(tracked).astype(bool) & v
    un = v & ~tr
    if n_tracked is None:
        n_tracked = int(tr.sum())

    fig, ax = plt.subplots(figsize=(w / 80.0, h / 80.0), dpi=80)
    ax.imshow(rgb, interpolation="nearest")
    ax.scatter(kp[un, 0], kp[un, 1], s=6, facecolors="none",
               edgecolors="#3b6fd4", linewidths=0.7)
    ax.scatter(kp[tr, 0], kp[tr, 1], s=8, facecolors="none",
               edgecolors="#27c24c", linewidths=0.9)
    ax.text(4, h - 6, f"{state} | matches: {n_tracked}",
            color="white", fontsize=8,
            bbox=dict(facecolor="black", alpha=0.6, pad=2))
    ax.set_xlim(0, w)
    ax.set_ylim(h, 0)
    ax.axis("off")
    fig.subplots_adjust(0, 0, 1, 1)
    fig.savefig(path)
    plt.close(fig)
