"""The port's committed simulator scene against a fresh JAX ``build_sim``.

``ov_plane_tpu_torch/data/sim_config1_truth.npz`` holds the noiseless truth
of the bench's simulator scene (``bench.py`` sim mode: 30 s, 60 points, 96
observation slots). This file is also its generator:

    env JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_scene.py
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ov_plane_tpu.sim.simulator import build_sim
from ov_plane_tpu.utils.config import sim_config as j_sim_config
from ov_plane_tpu_torch.sim import simulator as tsim
from ov_plane_tpu_torch.utils.config import slice_config

FIELDS = ("imu_t", "imu_w_true", "imu_a_true", "cam_t", "cam_t_imu", "obs_id", "obs_uv_true",
          "obs_plane", "imu_window_start", "gt_q", "gt_p", "gt_v")


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


def scene_arrays() -> dict:
    cfg = _bench_cfg()
    sim = build_sim(cfg, max_obs=cfg.tpu.max_obs_per_frame)
    out = {k: np.asarray(getattr(sim, k)) for k in FIELDS}
    out["obs_id"] = out["obs_id"].astype(np.int32)
    out["obs_plane"] = out["obs_plane"].astype(np.int32)
    out["imu_window_start"] = out["imu_window_start"].astype(np.int32)
    return out


@pytest.fixture(scope="module")
def fresh():
    return scene_arrays()


def test_committed_scene_matches_build_sim(fresh):
    with np.load(tsim.SCENE_PATH) as z:
        assert sorted(z.files) == sorted(FIELDS)
        for k in FIELDS:
            assert z[k].shape == fresh[k].shape, k
            if np.issubdtype(fresh[k].dtype, np.integer):
                np.testing.assert_array_equal(z[k], fresh[k], err_msg=k)
            else:
                np.testing.assert_allclose(z[k], fresh[k], rtol=0, atol=1e-9, err_msg=k)


def test_scene_shape_is_the_bench_scene():
    truth = tsim.load_scene()
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
    arrays = scene_arrays()
    np.savez_compressed(tsim.SCENE_PATH, **arrays)
    print(f"wrote {tsim.SCENE_PATH} ({Path(tsim.SCENE_PATH).stat().st_size} bytes, "
          f"{arrays['cam_t'].shape[0]} frames, {arrays['imu_t'].shape[0]} IMU samples)", file=sys.stderr)
