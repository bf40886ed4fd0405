"""The port's committed simulator scenes against a fresh JAX ``build_sim``.

``ov_plane_tpu_torch/data/sim_config1_truth.npz`` holds the noiseless truth
of the bench's simulator scene (``bench.py`` sim mode: 30 s, 60 points, 96
observation slots); ``sim_planes_truth.npz`` that of the M-PL scene
(``scripts/run_sweep.py`` ``VARIANTS["M-PL"]``: 30 s, 40 free points + 40
points on planes), with the true plane CPs; ``sim_vision_truth.npz`` that of
the vision bench (``bench.py`` vision mode: 6 s at 20 Hz, 64 observation
slots), with the room's planes that the frame renderer draws;
``sim_tabletop_truth.npz`` that of the JAX package's plane-firing scene
(``tests/test_fused_planes.py``: 6 s tabletop trajectory at 20 Hz, 50
points), with its planes. This file is also their generator:

    env JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_scene.py
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ov_plane_tpu.sim.simulator import build_sim, generate_planes
from ov_plane_tpu.sim.trajectory import get_trajectory
from ov_plane_tpu.utils.config import sim_config as j_sim_config
from ov_plane_tpu_torch.sim import simulator as tsim
from ov_plane_tpu_torch.utils.config import plane_config, slice_config, tabletop_config, vision_config

FIELDS = ("imu_t", "imu_w_true", "imu_a_true", "cam_t", "cam_t_imu", "obs_id", "obs_uv_true",
          "obs_plane", "imu_window_start", "gt_q", "gt_p", "gt_v")
PLANE_FIELDS = FIELDS + ("plane_cp",)
VISION_FIELDS = FIELDS + ("plane_corners", "plane_normal", "plane_d")


def _bench_cfg():
    """The JAX configuration of bench.py's sim mode (bench.py:493-510)."""
    cfg = j_sim_config()
    cfg.sim.traj_duration = 30.0
    cfg.state.max_slam_features = 0
    cfg.state.do_calib_camera_pose = False
    cfg.state.do_calib_camera_intrinsics = False
    cfg.state.do_calib_camera_timeoffset = False
    cfg.num_pts = 60
    cfg.num_pts_plane = 0
    cfg.tpu.max_features = 192
    cfg.tpu.max_obs_per_frame = 96
    cfg.tpu.max_msckf_update = 40
    cfg.tpu.use_info_compression = True
    cfg.tpu.max_planes = 1
    return cfg


def _plane_cfg():
    """The JAX configuration of the M-PL arm (scripts/run_sweep.py:64-79)."""
    cfg = j_sim_config()
    cfg.sim.traj_duration = 30.0
    cfg.state.max_slam_features = 0
    cfg.state.use_plane_constraint = True
    cfg.state.use_plane_slam_feats = True
    cfg.state.do_calib_camera_pose = False
    cfg.state.do_calib_camera_intrinsics = False
    cfg.state.do_calib_camera_timeoffset = False
    cfg.num_pts = 40
    cfg.num_pts_plane = 40
    cfg.tpu.max_features = 192
    cfg.tpu.max_obs_per_frame = 96
    cfg.tpu.max_msckf_update = 40
    cfg.tpu.use_info_compression = True
    return cfg


def _vision_cfg():
    """The JAX configuration of bench.py's vision mode (bench.py:121-163),
    80 frames."""
    cfg = j_sim_config()
    cfg.sim.traj_duration = max(6.0, (80 + 2) / 20.0)
    cfg.sim.freq_cam = 20.0
    cfg.state.max_slam_features = 0
    cfg.state.use_plane_constraint = True
    cfg.state.use_plane_slam_feats = True
    cfg.state.plane_init_min_feat = 8
    cfg.state.do_calib_camera_pose = False
    cfg.state.do_calib_camera_intrinsics = False
    cfg.state.do_calib_camera_timeoffset = False
    cfg.num_pts = 15
    cfg.num_pts_plane = 40
    cfg.cam_wh = [640, 480]
    cfg.cam_intrinsics = [300.0, 300.0, 320.0, 240.0, 0.0, 0.0, 0.0, 0.0]
    cfg.histogram_method = "NONE"
    cfg.tpu.max_features = 128
    cfg.tpu.max_obs_per_frame = 64
    cfg.tpu.max_msckf_update = 24
    cfg.tpu.use_info_compression = True
    cfg.trackplane.min_norms = 3
    cfg.trackplane.max_norm_avg_var = 30.0
    cfg.trackplane.max_norm_avg_max = 30.0
    cfg.msckf_options.chi2_multipler = 5.0
    cfg.sim.min_feature_gen_distance = 0.7
    cfg.sim.max_feature_gen_distance = 2.0
    cfg.state.plane_init_max_cond = 150.0
    cfg.state.plane_msckf_max_cond = 150.0
    cfg.msckf_options.sigma_pix = 2.0
    cfg.slam_options.sigma_pix = 2.0
    return cfg


def _tabletop_cfg():
    """The JAX configuration of tests/test_fused_planes.py:27-52: the
    tabletop trajectory under the reference's stock plane gates."""
    cfg = j_sim_config()
    cfg.sim.traj_duration = 6.0
    cfg.sim.freq_cam = 20.0
    cfg.sim.traj_kind = "tabletop"
    cfg.state.max_slam_features = 0
    cfg.state.use_plane_constraint = True
    cfg.state.use_plane_slam_feats = True
    cfg.state.do_calib_camera_pose = False
    cfg.state.do_calib_camera_intrinsics = False
    cfg.state.do_calib_camera_timeoffset = False
    cfg.num_pts = 50
    cfg.num_pts_plane = 0
    cfg.cam_wh = [640, 480]
    cfg.cam_intrinsics = [300.0, 300.0, 320.0, 240.0, 0.0, 0.0, 0.0, 0.0]
    cfg.histogram_method = "NONE"
    cfg.tpu.max_features = 128
    cfg.tpu.max_obs_per_frame = 64
    cfg.tpu.max_msckf_update = 24
    cfg.msckf_options.sigma_pix = 2.0
    cfg.slam_options.sigma_pix = 2.0
    cfg.sim.min_feature_gen_distance = 1.0
    return cfg


def scene_arrays(cfg=None, fields=FIELDS) -> dict:
    cfg = cfg or _bench_cfg()
    sim = build_sim(cfg, max_obs=cfg.tpu.max_obs_per_frame)
    out = {k: np.asarray(getattr(sim, k)) for k in fields if not k.startswith("plane_") or k == "plane_cp"}
    if "plane_corners" in fields:
        # The room the bench renders (bench.py:166-167).
        _, traj_pos, _ = get_trajectory(cfg.sim)
        planes = generate_planes(traj_pos, cfg.sim.min_feature_gen_distance)
        out.update(plane_corners=np.asarray(planes.corners), plane_normal=np.asarray(planes.normal),
                   plane_d=np.asarray(planes.d))
    out["obs_id"] = out["obs_id"].astype(np.int32)
    out["obs_plane"] = out["obs_plane"].astype(np.int32)
    out["imu_window_start"] = out["imu_window_start"].astype(np.int32)
    return out


@pytest.fixture(scope="module")
def fresh():
    return scene_arrays()


def _check_committed(path, fields, fresh):
    with np.load(path) as z:
        assert sorted(z.files) == sorted(fields)
        for k in fields:
            assert z[k].shape == fresh[k].shape, k
            if np.issubdtype(fresh[k].dtype, np.integer):
                np.testing.assert_array_equal(z[k], fresh[k], err_msg=k)
            else:
                np.testing.assert_allclose(z[k], fresh[k], rtol=0, atol=1e-9, err_msg=k)


def test_committed_scene_matches_build_sim(fresh):
    _check_committed(tsim.SCENE_PATH, FIELDS, fresh)


def test_committed_plane_scene_matches_build_sim():
    fresh = scene_arrays(_plane_cfg(), PLANE_FIELDS)
    _check_committed(tsim.PLANE_SCENE_PATH, PLANE_FIELDS, fresh)
    truth = tsim.load_scene(tsim.PLANE_SCENE_PATH, device="cpu")
    cfg = plane_config()
    assert truth.obs_id.shape[1] == cfg.tpu.max_obs_per_frame
    assert truth.plane_cp.shape[1] == 3 and truth.plane_cp.shape[0] >= 2
    # Points on planes are observed, labelled with the plane's index.
    labels = truth.obs_plane[truth.obs_id >= 0]
    assert (labels >= 0).any() and (labels < 0).any()
    assert int(labels.max()) < truth.plane_cp.shape[0]


def test_committed_vision_scene_matches_build_sim():
    fresh = scene_arrays(_vision_cfg(), VISION_FIELDS)
    _check_committed(tsim.VISION_SCENE_PATH, VISION_FIELDS, fresh)
    truth = tsim.load_scene(tsim.VISION_SCENE_PATH, device="cpu")
    cfg = vision_config()
    assert truth.obs_id.shape[1] == cfg.tpu.max_obs_per_frame
    assert truth.cam_t.shape[0] >= 81          # the bench's 80 frames after the first
    np.testing.assert_allclose(np.diff(truth.cam_t.numpy()), 1.0 / _vision_cfg().sim.freq_cam, atol=1e-9)
    P = truth.plane_corners.shape[0]
    assert truth.plane_corners.shape == (P, 4, 3) and truth.plane_normal.shape == (P, 3) and P >= 4
    # Each plane's corners lie on it (n·x = d).
    on = torch.einsum("pki,pi->pk", truth.plane_corners, truth.plane_normal) - truth.plane_d[:, None]
    assert on.abs().max() < 1e-9


def test_committed_tabletop_scene_matches_build_sim():
    jcfg = _tabletop_cfg()
    fresh = scene_arrays(jcfg, VISION_FIELDS)
    _check_committed(tsim.TABLETOP_SCENE_PATH, VISION_FIELDS, fresh)
    truth = tsim.load_scene(tsim.TABLETOP_SCENE_PATH, device="cpu")
    cfg = tabletop_config()
    for sec in ("state", "tpu", "msckf_options"):
        for k, v in vars(getattr(cfg, sec)).items():
            assert getattr(getattr(jcfg, sec), k) == v, (sec, k)
    for k in ("num_pts", "num_pts_plane", "cam_wh", "cam_intrinsics", "histogram_method", "cam_model"):
        assert getattr(jcfg, k) == getattr(cfg, k), k
    assert truth.obs_id.shape[1] == cfg.tpu.max_obs_per_frame
    # The simulator starts once the platform has moved: 47 camera frames, of
    # which the JAX test steps min(85, 46).
    assert truth.cam_t.shape[0] == 47
    np.testing.assert_allclose(np.diff(truth.cam_t.numpy()), 1.0 / jcfg.sim.freq_cam, atol=1e-9)
    on = torch.einsum("pki,pi->pk", truth.plane_corners, truth.plane_normal) - truth.plane_d[:, None]
    assert truth.plane_corners.shape[0] >= 2 and on.abs().max() < 1e-9


def test_scene_shape_is_the_bench_scene():
    truth = tsim.load_scene(device="cpu")
    cfg = slice_config()
    assert truth.obs_id.shape[1] == cfg.tpu.max_obs_per_frame
    assert truth.cam_t.shape[0] == truth.gt_q.shape[0] == truth.obs_uv_true.shape[0]
    assert truth.imu_window_start.max() + cfg.tpu.max_imu_per_frame <= truth.imu_t.shape[0] + 64
    # Monte-Carlo noise: distinct draws per stream, none on padding slots.
    g = torch.Generator().manual_seed(0)
    sim = tsim.apply_noise(truth, tsim.noise_params(cfg), 3, g)
    assert sim.obs_uv.shape == (3, *truth.obs_uv_true.shape)
    assert not torch.equal(sim.imu_w[0], sim.imu_w[1])
    pad = truth.obs_id < 0
    assert torch.equal(sim.obs_uv[:, pad], truth.obs_uv_true[pad].expand(3, -1, 2))
    assert torch.all(sim.gt_bg[:, 0] == 0)


if __name__ == "__main__":
    import jax

    jax.config.update("jax_enable_x64", True)
    for path, cfg, fields in ((tsim.SCENE_PATH, _bench_cfg(), FIELDS),
                              (tsim.PLANE_SCENE_PATH, _plane_cfg(), PLANE_FIELDS),
                              (tsim.VISION_SCENE_PATH, _vision_cfg(), VISION_FIELDS),
                              (tsim.TABLETOP_SCENE_PATH, _tabletop_cfg(), VISION_FIELDS)):
        arrays = scene_arrays(cfg, fields)
        np.savez_compressed(path, **arrays)
        print(f"wrote {path} ({Path(path).stat().st_size} bytes, "
              f"{arrays['cam_t'].shape[0]} frames, {arrays['imu_t'].shape[0]} IMU samples)", file=sys.stderr)
