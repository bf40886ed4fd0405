"""Parity of the port's plane RANSAC and ground-truth injection with the JAX package.

``plane_ransac`` takes its uniform draws as an input in the port; the tests
pass JAX's own (``split(key, num_hyps)``, one ``uniform`` row per
hypothesis) and hold inliers and acceptance equal and the CP to 1e-10, on
the inputs of tests/test_planefit.py. In a run, the port's
``plane_init.ransac_draws`` is replaced by JAX's draws for each plane id
(``fold_in(PRNGKey(8888), plane)``), so an M-PL window with
``use_plane_ransac`` on, past the first plane init, gives every counter
equal. Ground-truth injection runs the plane scene of
tests/test_e2e_planes.py through both ``run_sequence``s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_planefit import make_plane_points

from ov_plane_tpu.models.feature_bank import FeatureBank as JBank
from ov_plane_tpu.models.manager import VioEngine as JEngine
from ov_plane_tpu.models.manager import init_state_with_gt as j_init
from ov_plane_tpu.models.manager import run_sequence as j_run
from ov_plane_tpu.ops.planefit import PlaneRansacOptions as JRansacOptions
from ov_plane_tpu.ops.planefit import plane_ransac as j_plane_ransac
from ov_plane_tpu.sim.simulator import NoiseParams as JNoise
from ov_plane_tpu.sim.simulator import SimData as JSim
from ov_plane_tpu.sim.simulator import apply_noise as j_apply_noise
from ov_plane_tpu.sim.simulator import build_sim as j_build_sim
from ov_plane_tpu.utils.config import sim_config as j_sim_config
from ov_plane_tpu_torch import convert
from ov_plane_tpu_torch.models import plane_init
from ov_plane_tpu_torch.models.feature_bank import FeatureBank
from ov_plane_tpu_torch.models.manager import VioEngine, init_state_with_gt, run_sequence
from ov_plane_tpu_torch.ops.planefit import PlaneRansacOptions, plane_ransac
from ov_plane_tpu_torch.sim import simulator
from ov_plane_tpu_torch.utils.config import plane_config, sim_config

COUNTERS = ("n_msckf_used", "n_bank", "n_clones", "n_planes", "n_plane_init", "n_plane_constraints",
            "n_plane_merges", "n_plane_dropped")
RANSAC_FRAMES = 26   # the M-PL scene's first plane init is at frame 20
GT_FRAMES = 24


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def jax_draws(key, num_hyps, n):
    """The JAX plane_ransac's draws: one uniform row per hypothesis key."""
    keys = jax.random.split(key, num_hyps)
    return np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (n,), jnp.float64))(keys))


def _ransac_cases():
    rng = np.random.default_rng(42)
    cp1 = np.array([0.3, -0.8, 1.7])
    pts1 = np.vstack([make_plane_points(40, cp1, noise=0.005, rng=rng),
                      rng.uniform(-3, 3, size=(10, 3)) + np.array([0, 0, 5.0])])
    rng = np.random.default_rng(43)
    pts2 = np.vstack([make_plane_points(20, np.array([0.0, 0.0, 2.0]), rng=rng), rng.normal(size=(30, 3)) * 50])
    mask2 = np.concatenate([np.ones(20, bool), np.zeros(30, bool)])
    mask3 = np.zeros(50, bool)
    mask3[:3] = True
    return {
        "outliers": (pts1, np.ones(50, bool), 0, dict(num_hyps=64, inlier_thresh=0.03, min_inlier_ratio=0.5)),
        "masked": (pts2, mask2, 1, dict(num_hyps=32, inlier_thresh=0.02)),
        "degenerate": (pts2, mask3, 2, dict(num_hyps=32, inlier_thresh=0.02)),
    }


def test_plane_ransac_on_jax_draws():
    cases = _ransac_cases()
    for name, (pts, mask, seed, kw) in cases.items():
        key = jax.random.PRNGKey(seed)
        j_cp, j_inl, j_ok = j_plane_ransac(jnp.asarray(pts), jnp.asarray(mask), key, JRansacOptions(**kw))
        draws = jax_draws(key, kw["num_hyps"], len(pts))
        # Batched: two copies of the case (B = 2).
        cp, inl, ok = plane_ransac(t(np.stack([pts, pts])), torch.as_tensor(np.stack([mask, mask])),
                                   t(np.stack([draws, draws])), PlaneRansacOptions(**kw))
        for b in range(2):
            assert bool(ok[b]) == bool(j_ok), name
            np.testing.assert_array_equal(inl[b].numpy(), np.asarray(j_inl), err_msg=name)
            np.testing.assert_allclose(cp[b].numpy(), np.asarray(j_cp), rtol=1e-10, atol=1e-10, err_msg=name)
    assert [bool(j_plane_ransac(jnp.asarray(p), jnp.asarray(m), jax.random.PRNGKey(s), JRansacOptions(**k))[2])
            for p, m, s, k in cases.values()] == [True, True, False]


def test_ransac_draws_depend_on_the_plane_id_alone():
    d = plane_init.ransac_draws(torch.tensor([3, 7, 3, -1]), 16, 20, torch.float64)
    assert d.shape == (4, 16, 20) and float(d.min()) >= 0.0 and float(d.max()) < 1.0
    assert torch.equal(d[0], d[2]) and not torch.equal(d[0], d[1])
    assert abs(float(d.mean()) - 0.5) < 0.05


def _jax_config(cfg):
    jc = j_sim_config()
    for sec in ("state", "tpu", "msckf_options", "slam_options"):
        for k, v in vars(getattr(cfg, sec)).items():
            setattr(getattr(jc, sec), k, v)
    return jc


def _jax_sim(truth, sim, b, n):
    """Stream b of the port's noisy scene, cut to n camera frames, as a JAX SimData."""
    a = np.asarray
    O = truth.obs_id.shape[1]
    cam = dict(cam_t=a(truth.cam_t), cam_t_imu=a(truth.cam_t_imu), obs_id=a(truth.obs_id), obs_uv=a(sim.obs_uv[b]),
               obs_uv_true=a(truth.obs_uv_true), obs_plane=a(truth.obs_plane),
               imu_window_start=a(truth.imu_window_start).astype(np.int32), gt_q=a(truth.gt_q), gt_p=a(truth.gt_p),
               gt_v=a(truth.gt_v), gt_bg_cam=a(sim.gt_bg_cam[b]), gt_ba_cam=a(sim.gt_ba_cam[b]))
    return JSim(imu_t=a(truth.imu_t), imu_w=a(sim.imu_w[b]), imu_a=a(sim.imu_a[b]), imu_w_true=a(truth.imu_w_true),
                imu_a_true=a(truth.imu_a_true), gt_bg=a(sim.gt_bg[b]), gt_ba=a(sim.gt_ba[b]),
                obs_gt_p=np.zeros((n, O, 3)), obs_gt_cp=np.zeros((n, O, 3)), feat_p=np.zeros((1, 3)),
                feat_plane=np.zeros(1, np.int32), plane_cp=a(truth.plane_cp), **{k: v[:n] for k, v in cam.items()})


def _compare(outs, refs, state, pose_tol):
    for b, (jst, _, r) in enumerate(refs):
        for name in COUNTERS:
            np.testing.assert_array_equal(getattr(outs, name)[b].numpy(), np.asarray(getattr(r, name)), err_msg=name)
        np.testing.assert_allclose(outs.p[b].numpy(), np.asarray(r.p), rtol=0, atol=pose_tol)
        np.testing.assert_allclose(outs.q[b].numpy(), np.asarray(r.q), rtol=0, atol=pose_tol)
        np.testing.assert_array_equal(state.plane_id[b].numpy(), np.asarray(jst.plane_id))


def test_plane_ransac_window_matches_jax(monkeypatch):
    cfg = plane_config()
    cfg.state.use_plane_ransac = True
    truth = simulator.load_scene(simulator.PLANE_SCENE_PATH, device="cpu")
    sim = simulator.apply_noise(truth, simulator.noise_params(cfg), 2, torch.Generator().manual_seed(3))
    jc = _jax_config(cfg)
    jeng = JEngine.from_config(jc)
    eng = VioEngine.from_config(cfg, device="cpu")
    assert eng.plane_opts.use_ransac and jeng.plane_opts.use_ransac
    W = cfg.tpu.max_imu_per_frame
    refs = []
    for b in range(2):
        s = _jax_sim(truth, sim, b, RANSAC_FRAMES + 1)
        st = j_init(jeng, jc, t0=s.cam_t_imu[0], q0=s.gt_q[0], p0=s.gt_p[0], v0=s.gt_v[0], bg0=s.gt_bg_cam[0],
                    ba0=s.gt_ba_cam[0])
        refs.append(j_run(jeng, st, JBank.create(jc.tpu.max_features, jeng.layout.max_clones), s, imu_window=W))

    seen = set()

    def draws(plane, num_hyps, n, dtype):
        seen.update(int(p) for p in plane if p >= 0)
        return torch.as_tensor(np.stack([
            jax_draws(jax.random.fold_in(jax.random.PRNGKey(8888), jnp.int32(p)), num_hyps, n) for p in plane.tolist()
        ]), dtype=dtype)

    monkeypatch.setattr(plane_init, "ransac_draws", draws)
    state = init_state_with_gt(eng, cfg, t0=sim.cam_t_imu[0].expand(2), q0=sim.gt_q[0].expand(2, 4),
                               p0=sim.gt_p[0].expand(2, 3), v0=sim.gt_v[0].expand(2, 3),
                               bg0=sim.gt_bg_cam[:, 0], ba0=sim.gt_ba_cam[:, 0], device="cpu")
    bank = FeatureBank.create(cfg.tpu.max_features, eng.layout.max_clones, batch=2, device="cpu")
    state, _, outs = run_sequence(eng, state, bank, sim, imu_window=W, n_frames=RANSAC_FRAMES)
    _compare(outs, refs, state, 1e-6)
    # The window passes the first plane inits, with RANSAC on real candidates.
    assert int(outs.n_planes[:, :18].sum()) == 0 and int(outs.n_planes[:, -1].min()) >= 1
    assert seen


def _gt_config(cfg):
    """tests/test_e2e_planes.py's plane configuration with ground-truth injection."""
    cfg.state.max_slam_features = 0
    cfg.state.do_calib_camera_pose = False
    cfg.state.do_calib_camera_intrinsics = False
    cfg.state.do_calib_camera_timeoffset = False
    cfg.state.use_plane_constraint = True
    cfg.state.use_plane_slam_feats = True
    cfg.state.use_groundtruths = True
    cfg.tpu.max_features = 144
    cfg.tpu.max_obs_per_frame = 96
    cfg.tpu.max_msckf_update = 40
    return cfg


def test_ground_truth_injection_matches_jax():
    cfg = _gt_config(j_sim_config())
    cfg.sim.traj_duration = 10.0
    cfg.num_pts = 20
    cfg.num_pts_plane = 35
    scene = j_build_sim(cfg, max_obs=cfg.tpu.max_obs_per_frame)
    noise = JNoise(sigma_w=cfg.imu_noises.sigma_w, sigma_a=cfg.imu_noises.sigma_a,
                   sigma_wb=cfg.imu_noises.sigma_wb, sigma_ab=cfg.imu_noises.sigma_ab,
                   sigma_pix=cfg.msckf_options.sigma_pix, dt_imu=1.0 / cfg.sim.freq_imu)
    cam_fields = ("cam_t", "cam_t_imu", "obs_id", "obs_uv", "obs_uv_true", "obs_plane", "obs_gt_p",
                  "obs_gt_cp", "imu_window_start", "gt_q", "gt_p", "gt_v", "gt_bg_cam", "gt_ba_cam")
    eng_j = JEngine.from_config(cfg)
    streams, refs = [], []
    for seed in (1, 2):
        s = j_apply_noise(scene, jax.random.PRNGKey(seed), noise)
        s = s._replace(**{k: getattr(s, k)[:GT_FRAMES + 1] for k in cam_fields})
        st = j_init(eng_j, cfg, t0=s.cam_t_imu[0], q0=s.gt_q[0], p0=s.gt_p[0], v0=s.gt_v[0],
                    bg0=s.gt_bg_cam[0], ba0=s.gt_ba_cam[0])
        refs.append(j_run(eng_j, st, JBank.create(cfg.tpu.max_features, eng_j.layout.max_clones), s,
                          imu_window=cfg.tpu.max_imu_per_frame))
        streams.append({k: np.asarray(v) for k, v in s._asdict().items()})

    pcfg = _gt_config(sim_config())
    eng = VioEngine.from_config(pcfg, device="cpu")
    sim = convert.sim_from_streams(streams, device="cpu")
    assert float(sim.obs_gt_p.abs().sum()) > 0 and float(sim.obs_gt_cp.abs().sum()) > 0
    state = init_state_with_gt(eng, pcfg, t0=sim.cam_t_imu[0].expand(2), q0=sim.gt_q[0].expand(2, 4),
                               p0=sim.gt_p[0].expand(2, 3), v0=sim.gt_v[0].expand(2, 3),
                               bg0=sim.gt_bg_cam[:, 0], ba0=sim.gt_ba_cam[:, 0], device="cpu")
    bank = FeatureBank.create(pcfg.tpu.max_features, eng.layout.max_clones, batch=2, device="cpu")
    state, bank, outs = run_sequence(eng, state, bank, sim, imu_window=pcfg.tpu.max_imu_per_frame)
    _compare(outs, refs, state, 1e-6)
    assert float(bank.gt_p.abs().sum()) > 0          # the bank carries the truth
    assert int(outs.n_msckf_used.sum()) > 50 and int(outs.n_plane_constraints.sum()) > 0
