"""CPU rehearsal of chip_smoke.py's phase functions at a tiny size: the
device phase refuses the CPU, and the stereo, stereo-inertial and parity
phases run end to end on the deployments' configs with the image size,
feature budget and pools shrunk (the script itself runs them at full width
on the GPU)."""
import dataclasses

import jax
import numpy as np
import pytest

import chip_smoke
from ms_slam.models.map_state import MapConfig
from ms_slam.ops.orb import OrbConfig

H, W, FX, BL = 240, 320, 260.0, 0.15


def tiny(cfg, **kw):
    calib = cfg.calib._replace(
        params=(FX, FX, W / 2, H / 2), bf=FX * BL, width=W, height=H,
        th_depth=BL * 45, fps=10.0)
    orb = OrbConfig(n_features=512, n_levels=4)
    return dataclasses.replace(
        cfg, calib=calib, orb=orb,
        map=MapConfig(max_kf=96, max_mp=12288, n_feat=512, local_mp_cap=2048,
                      window_kf=6, grid_w=16, grid_h=12),
        min_init_depth_points=100, max_frames_between_kf=3, **kw)


def test_device_phase_refuses_cpu():
    with pytest.raises(RuntimeError, match="'cpu'"):
        chip_smoke.phase_device()


def test_stereo_phase_rehearsal():
    cfg = tiny(chip_smoke.stereo_config(), sparsify_n=40, sparsify_window=4,
               sparsify_queue_min=2, nonlocal_kf=3, loop_covis_min=30)
    # one in-place orbit of a small room, then 32 frames into lap two
    s = chip_smoke.run_stereo(cfg, n_frames=112, lap=80, radius=0.8,
                              room_half=7.0)
    assert s["state"] == "OK", s
    assert s["sparsify_windows"] >= 1, s
    assert s["loops"] >= 1, s
    assert s["ate_m"] < 0.09 * s["path_m"], s   # the tiny orbit's bar
    assert s["steady_frames"] + s["frames_with_compile"] == 112, s


def test_inertial_phase_rehearsal():
    cfg = tiny(chip_smoke.inertial_config(), imu_init_kfs=6,
               imu_init_time=0.5)
    assert cfg.use_imu and cfg.Tbc is not None
    s = chip_smoke.run_inertial(cfg, n_frames=65)
    assert s["imu_initialized"], s
    assert s["state"] == "OK", s
    assert s["ate_m"] < 0.025 * s["path_m"], s


def test_parity_phase_rehearsal():
    cpu = jax.devices("cpu")
    cfg = tiny(chip_smoke.stereo_config())
    rng = np.random.default_rng(0)
    from ms_slam.utils import synth
    pair = np.stack([synth.mondrian_texture(rng, size=W)[:H, :W]] * 2)
    out = chip_smoke.run_parity(cpu[0], cpu[1], cfg, pair=pair)
    assert out["orb"]["hit_frac"] == 1.0
    assert out["hamming"]["mismatches"] == 0
    assert out["pose_opt"]["max_dt"] == 0.0
    assert out["ba"]["max_dt_m"] == 0.0
