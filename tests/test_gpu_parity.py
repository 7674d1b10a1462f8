"""GPU against CPU-backend parity at the KITTI deployment's widths (the
checks live in ms_slam/utils/parity.py; chip_smoke.py runs the same ones).
Skips where JAX finds no GPU. Run on a card with:
    python -m pytest -m gpu tests/test_gpu_parity.py
"""
import jax
import numpy as np
import pytest

import chip_smoke
from ms_slam.utils import parity

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def devices():
    try:
        gpus = jax.devices("gpu")
    except RuntimeError:
        gpus = []
    if not gpus:
        pytest.skip("needs an NVIDIA GPU; JAX finds none")
    return gpus[0], jax.devices("cpu")[0]


@pytest.fixture(scope="module")
def kitti():
    return chip_smoke.stereo_config()


def test_orb_parity(devices, kitti):
    from ms_slam.utils import synth
    K, bl, h, w = chip_smoke.intrinsics(kitti.calib)
    world = synth.BoxWorld(np.random.default_rng(2), half=24.0)
    pair = np.stack(chip_smoke.render_all(
        world, K, bl, h, w, chip_smoke.circuit(1, 300, 9.0))[0])
    parity.orb_parity(*devices, pair, kitti.orb)


def test_hamming_parity(devices, kitti):
    parity.hamming_parity(*devices, kitti.orb.n_features,
                          kitti.map.local_mp_cap)


def test_pose_opt_parity(devices, kitti):
    parity.pose_opt_parity(*devices, n=kitti.orb.n_features)


def test_ba_parity(devices, kitti):
    parity.ba_parity(*devices,
                     n_cams=kitti.map.window_kf + kitti.n_fixed_cams,
                     n_feat=kitti.orb.n_features,
                     n_pts=kitti.map.local_mp_cap)
