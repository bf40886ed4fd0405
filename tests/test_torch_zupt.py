"""Parity of the port's zero-velocity update with the JAX package.

On the inputs of the JAX package's own ZUPT tests (tests/test_updaters.py:
a stationary IMU window, a rotating one, the low-disparity override, a
moving state), each formulation (standard, ``integrated_accel``,
``explicit_zero_motion``) runs in JAX one stream at a time and in the port
as one batch, on the CPU in f64: accept flags equal, state and covariance
within 1e-10. Then the two in-step scenarios are stepped by both
``manager.step``s: time, clone count and ``has_moved`` equal, the state
within 1e-9.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ov_plane_tpu.models import zupt as j_zupt
from ov_plane_tpu.models.feature_bank import FeatureBank as JBank
from ov_plane_tpu.models.manager import FrameData as JFrame
from ov_plane_tpu.models.manager import VioEngine as JEngine
from ov_plane_tpu.models.manager import init_state_with_gt as j_init
from ov_plane_tpu.models.manager import step as j_step
from ov_plane_tpu.ops.quat import quat_2_rot as j_quat_2_rot
from ov_plane_tpu.state.layout import StateLayout as JLayout
from ov_plane_tpu.state.vio_state import VioState as JState
from ov_plane_tpu.utils.config import sim_config as j_sim_config
from ov_plane_tpu_torch import convert
from ov_plane_tpu_torch.models import zupt
from ov_plane_tpu_torch.models.feature_bank import FeatureBank
from ov_plane_tpu_torch.models.manager import FrameData, VioEngine, init_state_with_gt, step
from ov_plane_tpu_torch.state.layout import StateLayout
from ov_plane_tpu_torch.utils.config import sim_config

TOL = dict(rtol=1e-10, atol=1e-10)
FIELDS = ("t", "last_dt", "imu", "calib_dt", "calib_cam", "cam_zeta", "clones_q", "clones_p", "clones_t", "cov")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), **(tol or TOL))


def arrays(tree):
    return {k: np.asarray(v) for k, v in vars(tree).items() if k != "layout"}


def port_state(jstates, lay):
    return convert.state_from_arrays(convert.stack_streams([arrays(s) for s in jstates]), lay, device="cpu")


def close_state(port, jstates, **tol):
    for b, s in enumerate(jstates):
        for name in FIELDS:
            close(getattr(port, name)[b], getattr(s, name), **tol)


def _windows():
    """The test_updaters.py windows as B = 4 streams: stationary, rotating,
    rotating with the low-disparity override, stationary from a moving state."""
    rng = np.random.default_rng(11)
    n = 21
    t_imu = np.arange(n) / 100.0
    w_still = 1e-5 * rng.normal(size=(n, 3))
    a_still = np.tile([0, 0, 9.81], (n, 1)) + 1e-4 * rng.normal(size=(n, 3))
    w_fast = np.tile([0.5, 0, 0], (n, 1))
    imu_w = np.stack([w_still, w_fast, w_fast, w_still])
    imu_a = np.stack([a_still] * 4)
    disp = np.array([10.0, 10.0, 0.1, 10.0])
    n_disp = np.array([0, 0, 50, 0])
    vel = np.array([[0.0] * 3, [0.0] * 3, [0.0] * 3, [0.5, 0.0, 0.0]])
    return t_imu, imu_w, imu_a, disp, n_disp, vel


def _states(jlay, vel):
    base = JState.create(jlay).replace(cov=jnp.eye(jlay.dim) * 1e-4, t=jnp.asarray(0.0))
    return [base.replace(imu=base.imu.at[7:10].set(jnp.asarray(v))) for v in vel]


@pytest.mark.parametrize("integrated", [False, True], ids=["standard", "integrated_accel"])
def test_try_zupt_matches_jax(integrated):
    kw = dict(max_clones=3, max_slam=2, max_planes=1)   # calibration blocks on, as in test_updaters.py
    jlay, lay = JLayout(**kw), StateLayout(**kw)
    t_imu, imu_w, imu_a, disp, n_disp, vel = _windows()
    jstates = _states(jlay, vel)
    j_opts = j_zupt.ZuptOptions(chi2_multipler=1.0, noise_multiplier=10.0, gravity_mag=9.81,
                                integrated_accel=integrated)
    opts = zupt.ZuptOptions(chi2_multipler=1.0, noise_multiplier=10.0, gravity_mag=9.81,
                            integrated_accel=integrated)
    B = len(jstates)
    out, acc = zupt.try_zupt(port_state(jstates, lay), opts, t(np.tile(t_imu, (B, 1))), t(imu_w), t(imu_a),
                             t(np.full(B, 0.2)), t(disp), torch.as_tensor(n_disp))
    refs = [j_zupt.try_zupt(s, j_opts, t_imu, imu_w[b], imu_a[b], 0.2, jnp.asarray(disp[b]),
                            jnp.asarray(n_disp[b])) for b, s in enumerate(jstates)]
    np.testing.assert_array_equal(acc.numpy(), [bool(a) for _, a in refs])
    assert acc.tolist() == [True, False, True, False]  # the moving state fails the velocity gate
    close_state(out, [s for s, _ in refs])


def test_zupt_explicit_update_matches_jax():
    kw = dict(max_clones=4, max_slam=1, max_planes=1)
    jlay, lay = JLayout(**kw), StateLayout(**kw)
    rng = np.random.default_rng(12)
    jstates = []
    for b in range(3):
        q = rng.normal(size=(4, 4))
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
        A = rng.normal(size=(jlay.dim, jlay.dim))
        jstates.append(JState.create(jlay).replace(
            imu=JState.create(jlay).imu.at[7:10].set(jnp.asarray(0.05 * rng.normal(size=3))),
            cov=jnp.asarray(1e-3 * A @ A.T / jlay.dim + 1e-4 * np.eye(jlay.dim)),
            clones_q=jnp.asarray(q), clones_q_fej=jnp.asarray(q[::-1].copy()),
            clones_p=jnp.asarray(rng.normal(size=(4, 3))), clones_p_fej=jnp.asarray(rng.normal(size=(4, 3))),
            clones_t=jnp.asarray([0.1, 0.2, 0.3, 0.4])))
    slot0, slot1 = np.array([0, 2, 3]), np.array([1, 0, 2])
    opts = zupt.ZuptOptions()
    out = zupt.zupt_explicit_update(port_state(jstates, lay), opts, torch.as_tensor(slot0), torch.as_tensor(slot1))
    refs = [j_zupt.zupt_explicit_update(s, j_zupt.ZuptOptions(), jnp.asarray(slot0[b]), jnp.asarray(slot1[b]))
            for b, s in enumerate(jstates)]
    close_state(out, refs)
    assert not torch.isfinite(out.clones_t[torch.arange(3), torch.as_tensor(slot1)]).any()


def test_compute_disparity():
    rng = np.random.default_rng(13)
    B, F, K = 3, 9, 4
    uv = rng.uniform(0, 600, size=(B, F, K, 2))
    mask = rng.uniform(size=(B, F, K)) < 0.6
    prev, cur = np.array([0, 1, 3]), np.array([1, 3, 2])
    avg, n = zupt.compute_disparity(t(uv), torch.as_tensor(mask), torch.as_tensor(prev), torch.as_tensor(cur))
    for b in range(B):
        j_avg, j_n = j_zupt.compute_disparity(uv[b], mask[b], int(prev[b]), int(cur[b]))
        assert int(n[b]) == int(j_n)
        close(avg[b], j_avg)


def _step_config(cfg, explicit):
    """test_updaters.py's in-step configuration."""
    cfg.try_zupt = True
    cfg.zupt_options.chi2_multipler = 1.0
    cfg.zupt_max_disparity = 0.0
    if explicit:
        cfg.zupt_only_at_beginning = False
        cfg.zupt_explicit_zero_motion = True
    cfg.state.max_slam_features = 0
    cfg.state.use_plane_constraint = False
    cfg.state.use_plane_slam_feats = False
    cfg.state.do_calib_camera_pose = False
    cfg.state.do_calib_camera_intrinsics = False
    cfg.state.do_calib_camera_timeoffset = False
    cfg.tpu.max_features = 32
    cfg.tpu.max_obs_per_frame = 16
    cfg.tpu.max_msckf_update = 8
    cfg.tpu.max_imu_per_frame = 16
    return cfg


@pytest.mark.parametrize("explicit", [False, True], ids=["skips_cloning", "explicit_zero_motion"])
def test_zupt_in_step_matches_jax(explicit):
    """test_zupt_in_step_skips_cloning and test_zupt_explicit_zero_motion_in_step,
    stepped by JAX (one stream at a time) and by the port (B = 2 noise draws)."""
    jcfg, cfg = _step_config(j_sim_config(), explicit), _step_config(sim_config(), explicit)
    j_eng, eng = JEngine.from_config(jcfg), VioEngine.from_config(cfg, device="cpu")
    B, n = 2, cfg.tpu.max_imu_per_frame
    z3 = jnp.zeros(3)
    q0 = jnp.asarray([0.0, 0.0, 0.0, 1.0])
    jst = [j_init(j_eng, jcfg, t0=0.0, q0=q0, p0=z3, v0=z3, bg0=z3, ba0=z3) for _ in range(B)]
    jbk = [JBank.create(jcfg.tpu.max_features, j_eng.layout.max_clones) for _ in range(B)]
    zb = torch.zeros(B, 3, dtype=torch.float64)
    st = init_state_with_gt(eng, cfg, t0=torch.zeros(B), q0=t(np.tile([0.0, 0, 0, 1], (B, 1))), p0=zb, v0=zb,
                            bg0=zb, ba0=zb, device="cpu")
    bank = FeatureBank.create(cfg.tpu.max_features, eng.layout.max_clones, B, device="cpu")
    rng = np.random.default_rng(11)
    empty = dict(obs_id=np.full(16, -1, np.int32), obs_uv=np.zeros((16, 2)), obs_plane=np.full(16, -1, np.int32))
    for k in range(3):
        ts = np.linspace(k * 0.1, (k + 1) * 0.1, n)
        ws, accs = [], []
        for b in range(B):
            if explicit and k == 0:
                w, a = np.tile([0.5, 0, 0], (n, 1)), np.tile([0, 0, cfg.gravity_mag], (n, 1))
            else:
                # A stationary (tilted) IMU measures R_GtoI·g in the body frame.
                a_body = np.asarray(j_quat_2_rot(jst[b].imu[0:4])) @ np.array([0, 0, cfg.gravity_mag])
                w = 1e-5 * rng.normal(size=(n, 3))
                a = np.tile(a_body, (n, 1)) + 1e-4 * rng.normal(size=(n, 3))
            ws.append(w)
            accs.append(a)
            jst[b], jbk[b], _ = j_step(j_eng, jst[b], jbk[b], JFrame(
                imu_t=jnp.asarray(ts), imu_w=jnp.asarray(w), imu_a=jnp.asarray(a), t_new=jnp.asarray((k + 1) * 0.1),
                **{key: jnp.asarray(v) for key, v in empty.items()}))
        frame = FrameData(imu_t=t(np.tile(ts, (B, 1))), imu_w=t(ws), imu_a=t(accs), t_new=t(np.full(B, (k + 1) * 0.1)),
                          **{key: torch.as_tensor(np.tile(v, (B,) + (1,) * v.ndim)) for key, v in empty.items()})
        st, bank, _ = step(eng, st, bank, frame)
        for b in range(B):
            assert float(st.t[b]) == float(jst[b].t)
            assert int(st.num_clones[b]) == int(jst[b].num_clones)
            assert bool(st.has_moved[b]) == bool(jst[b].has_moved)
        close_state(st, jst, rtol=1e-9, atol=1e-9)
    assert st.num_clones.tolist() == [1 if explicit else 0] * B
    assert not st.has_moved.any() or explicit
