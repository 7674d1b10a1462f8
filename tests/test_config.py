import pytest

from ms_slam.utils.config import Settings


def test_parse_kitti_yaml():
    st = Settings("configs/KITTI00-02.yaml")
    calib = st.calib()
    assert abs(calib.params[0] - 718.856) < 1e-6
    assert calib.bf == 386.1448
    assert calib.width == 1241 and calib.height == 376
    # ThDepth in meters = bf * 35 / fx
    assert abs(calib.th_depth - 386.1448 * 35 / 718.856) < 1e-3
    orb = st.orb()
    assert orb.n_features == 2048  # 2000 rounded up to x128
    assert orb.n_levels == 8
    cfg = st.system_config()
    assert cfg.sparsify and cfg.sparsify_n == 100
    assert cfg.sparsify_lambda == 500 and cfg.nonlocal_kf == 30
    assert cfg.sparsify_window == 30
    assert cfg.loop_closing


def test_parse_euroc_yaml():
    st = Settings("configs/EuRoC.yaml")
    cfg = st.system_config()
    assert cfg.sparsify_n == 75 and cfg.nonlocal_kf == 15
    assert len(st.flat["K_l"]) == 9


def test_parse_inertial_yaml():
    st = Settings("configs/EuRoC-Inertial.yaml")
    cfg = st.system_config()
    assert cfg.use_imu
    assert abs(cfg.imu_noise_gyro - 1.7e-4) < 1e-9
    assert abs(cfg.imu_acc_walk - 3e-3) < 1e-9
    assert cfg.Tbc is not None and cfg.Tbc.shape == (4, 4)
    assert abs(cfg.Tbc[1, 0] - 0.999557249008) < 1e-9
    # stereo config has no IMU block
    assert not Settings("configs/EuRoC.yaml").system_config().use_imu


def test_parse_fisheye_yaml():
    """Stereo-fisheye section (ref Settings::readCamera2 + Stereo.T_c1_c2
    + overlapping columns, src/Settings.cc:263-333)."""
    st = Settings("configs/TUM-VI-Fisheye.yaml")
    calib = st.calib()
    assert calib.model == 1                       # KB8
    assert calib.is_fisheye_stereo
    assert len(calib.params2) == 8
    assert len(calib.T_rl) == 12
    assert calib.lapping == (0, 511, 0, 511)
    # baseline ~10.1 cm -> right-from-left translation x ~ -0.101
    assert abs(calib.T_rl[3] + 0.101063) < 2e-3, calib.T_rl
    assert calib.bf > 0


def test_parse_all_shipped_configs():
    import glob
    for path in glob.glob("configs/*.yaml"):
        cfg = Settings(path).system_config()
        assert cfg.calib.width > 0, path
        assert cfg.sparsify, path


CONFIGS = ["configs/4season.yaml", "configs/EuRoC-Inertial.yaml",
           "configs/EuRoC.yaml", "configs/KITTI00-02.yaml",
           "configs/KITTI03.yaml", "configs/KITTI04-12.yaml",
           "configs/TUM-VI-Fisheye.yaml"]


def _yaml_reference_flat(path):
    """Flattened keys as PyYAML reads the file (OpenCV header and matrix
    tag stripped, as the reader used to do)."""
    import yaml
    text = open(path).read()
    if text.startswith("%YAML"):
        text = text.split("\n", 1)[1]
    st = Settings.__new__(Settings)
    st.flat = {}
    st._flatten("", yaml.safe_load(text.replace("!!opencv-matrix", "")) or {})
    return st.flat


def test_shipped_config_list_is_complete():
    import glob
    assert sorted(glob.glob("configs/*.yaml")) == CONFIGS


@pytest.mark.parametrize("path", CONFIGS)
def test_reader_matches_pyyaml(path):
    ref = _yaml_reference_flat(path)
    got = Settings(path).flat
    assert got.keys() == ref.keys()
    for k, v in ref.items():
        assert got[k] == v and type(got[k]) is type(v), (k, got[k], v)


def test_config_imports_without_pyyaml(monkeypatch):
    import importlib
    import sys
    monkeypatch.setitem(sys.modules, "yaml", None)
    monkeypatch.delitem(sys.modules, "ms_slam.utils.config")
    config = importlib.import_module("ms_slam.utils.config")
    cfg = config.Settings("configs/KITTI00-02.yaml").system_config()
    assert cfg.orb.n_features == 2048 and cfg.calib.width == 1241


def test_reader_subset_edge_cases():
    from ms_slam.utils.config import parse_opencv_yaml
    text = """%YAML:1.0
---
a.b: "x # not a comment"   # comment
n: -3
f: 1.5e-3
empty:
m: !!opencv-matrix
  rows: 2
  cols: 1
  dt: d
  data: [ 1.0,
          2 ]
after: 'q'
"""
    d = parse_opencv_yaml(text)
    assert d == {"a.b": "x # not a comment", "n": -3, "f": 1.5e-3,
                 "empty": None,
                 "m": {"rows": 2, "cols": 1, "dt": "d", "data": [1.0, 2]},
                 "after": "q"}
