"""Parity of the port's batched point-MSCKF filter with the JAX package.

The same noisy simulator streams (two JAX ``apply_noise`` draws of a small
scene) go through the JAX ``run_sequence`` one stream at a time and through
the port's ``run_sequence`` as one B=2 batch on the CPU in f64. The
trajectory, the IMU covariance diagonal and the per-frame counters must
agree on every frame, with information-form compression on and off.
"""

import jax
import numpy as np
import pytest
import torch

from ov_plane_tpu.models.feature_bank import FeatureBank as JBank
from ov_plane_tpu.models.manager import VioEngine as JEngine
from ov_plane_tpu.models.manager import init_state_with_gt as j_init
from ov_plane_tpu.models.manager import run_sequence as j_run
from ov_plane_tpu.sim.simulator import NoiseParams as JNoise
from ov_plane_tpu.sim.simulator import apply_noise as j_apply_noise
from ov_plane_tpu.sim.simulator import build_sim
from ov_plane_tpu.utils.config import sim_config as j_sim_config
from ov_plane_tpu_torch import convert
from ov_plane_tpu_torch.models.feature_bank import FeatureBank
from ov_plane_tpu_torch.models.manager import VioEngine, init_state_with_gt, run_sequence
from ov_plane_tpu_torch.utils.config import sim_config

N_FRAMES = 30
SEEDS = (1, 2)


def _configure(cfg, info: bool):
    """The filter settings, applied alike to the JAX and the port config."""
    cfg.state.max_slam_features = 0
    cfg.state.do_calib_camera_pose = False
    cfg.state.do_calib_camera_intrinsics = False
    cfg.state.do_calib_camera_timeoffset = False
    cfg.state.use_plane_constraint = False
    cfg.tpu.max_features = 128
    cfg.tpu.max_obs_per_frame = 80
    cfg.tpu.max_planes = 1
    cfg.tpu.use_info_compression = info
    return cfg


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def streams():
    """Two noisy draws of the small scene, cut to N_FRAMES + 1 camera frames."""
    cfg = _configure(j_sim_config(), True)
    cfg.sim.traj_duration = 10.0
    cfg.num_pts = 40
    cfg.num_pts_plane = 0
    sim = build_sim(cfg, max_obs=cfg.tpu.max_obs_per_frame)
    noise = JNoise(sigma_w=cfg.imu_noises.sigma_w, sigma_a=cfg.imu_noises.sigma_a,
                   sigma_wb=cfg.imu_noises.sigma_wb, sigma_ab=cfg.imu_noises.sigma_ab,
                   sigma_pix=cfg.msckf_options.sigma_pix, dt_imu=1.0 / cfg.sim.freq_imu)
    cam_fields = ("cam_t", "cam_t_imu", "obs_id", "obs_uv", "obs_uv_true", "obs_plane", "obs_gt_p",
                  "obs_gt_cp", "imu_window_start", "gt_q", "gt_p", "gt_v", "gt_bg_cam", "gt_ba_cam")
    out = []
    for seed in SEEDS:
        s = j_apply_noise(sim, jax.random.PRNGKey(seed), noise)
        out.append(s._replace(**{k: getattr(s, k)[:N_FRAMES + 1] for k in cam_fields}))
    return out


def _jax_run(sim, info):
    cfg = _configure(j_sim_config(), info)
    eng = JEngine.from_config(cfg)
    st = j_init(eng, cfg, t0=sim.cam_t_imu[0], q0=sim.gt_q[0], p0=sim.gt_p[0], v0=sim.gt_v[0],
                bg0=sim.gt_bg_cam[0], ba0=sim.gt_ba_cam[0])
    bank = JBank.create(cfg.tpu.max_features, eng.layout.max_clones)
    _, _, outs = j_run(eng, st, bank, sim, imu_window=cfg.tpu.max_imu_per_frame)
    return outs


@pytest.mark.parametrize("info", [True, False], ids=["info_form", "qr"])
def test_slice_matches_jax_run_sequence(streams, info):
    ref = [_jax_run(s, info) for s in streams]

    cfg = _configure(sim_config(), info)
    eng = VioEngine.from_config(cfg, device="cpu")
    sim = convert.sim_from_streams([{k: np.asarray(v) for k, v in s._asdict().items()} for s in streams])
    state = init_state_with_gt(eng, cfg, t0=sim.cam_t_imu[0].expand(2), q0=sim.gt_q[0].expand(2, 4),
                               p0=sim.gt_p[0].expand(2, 3), v0=sim.gt_v[0].expand(2, 3),
                               bg0=sim.gt_bg_cam[:, 0], ba0=sim.gt_ba_cam[:, 0], device="cpu")
    bank = FeatureBank.create(cfg.tpu.max_features, eng.layout.max_clones, batch=2, device="cpu")
    _, _, outs = run_sequence(eng, state, bank, sim, imu_window=cfg.tpu.max_imu_per_frame)
    assert outs.p.shape == (2, N_FRAMES, 3)

    for b, r in enumerate(ref):
        for name in ("n_msckf_used", "n_bank", "n_clones"):
            np.testing.assert_array_equal(getattr(outs, name)[b].numpy(), np.asarray(getattr(r, name)),
                                          err_msg=name)
        np.testing.assert_allclose(outs.p[b].numpy(), np.asarray(r.p), rtol=0, atol=1e-6)
        np.testing.assert_allclose(outs.v[b].numpy(), np.asarray(r.v), rtol=0, atol=1e-6)
        np.testing.assert_allclose(outs.q[b].numpy(), np.asarray(r.q), rtol=0, atol=1e-7)
        np.testing.assert_allclose(outs.cov_diag_imu[b].numpy(), np.asarray(r.cov_diag_imu),
                                   rtol=1e-6, atol=0)
    # The comparison must cover real updates, not dead reckoning.
    assert int(outs.n_msckf_used.sum()) > 50
