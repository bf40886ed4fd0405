"""Parity of the port's online camera calibration with the JAX package.

The same numpy inputs go through each JAX function one stream at a time and
through its port counterpart with a leading stream dimension, on the CPU in
f64 (tolerance 1e-10): the time-offset clone coupling, the calibration rows
of ``apply_dx`` under every flag combination, the extrinsic and intrinsic
columns of ``feature_jacobian_full`` (GLOBAL_3D and an anchored
representation) and ``propagate_and_clone`` with the time offset. Then 30
frames of ``run_sequence`` with all three calibration blocks on, on the
calibration scene of the JAX package's tests (a 15 ms camera-IMU offset, the
filter starting from ``perturb_calibration(cfg, seed=1)`` and dt = 0), JAX
against the port from the same noisy streams.
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ov_plane_tpu.models import jacobians as j_jac
from ov_plane_tpu.models.feature_bank import FeatureBank as JBank
from ov_plane_tpu.models.manager import VioEngine as JEngine
from ov_plane_tpu.models.manager import init_state_with_gt as j_init
from ov_plane_tpu.models.manager import run_sequence as j_run
from ov_plane_tpu.ops import cams as j_cams
from ov_plane_tpu.ops import ekf as j_ekf
from ov_plane_tpu.sim.simulator import NoiseParams as JNoise
from ov_plane_tpu.sim.simulator import apply_noise as j_apply_noise
from ov_plane_tpu.sim.simulator import build_sim as j_build_sim
from ov_plane_tpu.sim.simulator import perturb_calibration as j_perturb
from ov_plane_tpu.state import layout as j_layout
from ov_plane_tpu.state import propagator as j_prop
from ov_plane_tpu.state import vio_state as j_vs
from ov_plane_tpu.utils.config import sim_config as j_sim_config
from ov_plane_tpu_torch import convert
from ov_plane_tpu_torch.models import jacobians as jac
from ov_plane_tpu_torch.models.feature_bank import FeatureBank
from ov_plane_tpu_torch.models.manager import VioEngine, init_state_with_gt, run_sequence
from ov_plane_tpu_torch.ops import cams, ekf
from ov_plane_tpu_torch.ops import representations as reps
from ov_plane_tpu_torch.state import propagator as prop
from ov_plane_tpu_torch.state.layout import StateLayout
from ov_plane_tpu_torch.utils.config import sim_config

TOL = dict(rtol=1e-10, atol=1e-10)
RADTAN_ZETA = [458.654, 457.296, 367.215, 248.375, -0.28340811, 0.07395907, 0.00019359, 1.76187114e-05]
K_CLONES = 6
FLAGS = list(itertools.product([False, True], repeat=3))
N_FRAMES = 30
SEEDS = (1, 2)


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


def layouts(dt=True, pose=True, intr=True):
    kw = dict(max_clones=K_CLONES, max_slam=1, max_planes=1, calib_dt=dt, calib_pose=pose, calib_intr=intr)
    return j_layout.StateLayout(**kw), StateLayout(**kw)


def unit_quats(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return q * np.sign(q[:, 3:4])


def jax_state(rng, jlay, n_clones):
    """A random JAX VioState with calibration means off their defaults."""
    K, D = jlay.max_clones, jlay.dim
    q = unit_quats(rng, 1 + 2 * K)
    imu = np.concatenate([q[0], rng.normal(size=3), rng.normal(size=3), 1e-3 * rng.normal(size=3),
                          1e-2 * rng.normal(size=3)])
    fej = imu.copy()
    fej[4:10] += 1e-3 * rng.normal(size=6)
    A = rng.normal(size=(D, D))
    cov = 1e-3 * (A @ A.T) / D + 1e-4 * np.eye(D)
    clones_t = np.full(K, -np.inf)
    clones_t[:n_clones] = 0.1 * rng.permutation(n_clones) + 1.0
    q_ic = unit_quats(rng, 1)[0] * np.array([0.05, 0.05, 0.05, 1.0])
    return j_vs.VioState.create(jlay).replace(
        t=jnp.asarray(2.0), imu=jnp.asarray(imu), imu_fej=jnp.asarray(fej), cov=jnp.asarray(cov),
        clones_q=jnp.asarray(q[1:K + 1]), clones_q_fej=jnp.asarray(q[K + 1:]),
        clones_p=jnp.asarray(rng.normal(size=(K, 3))),
        clones_p_fej=jnp.asarray(rng.normal(size=(K, 3))), clones_t=jnp.asarray(clones_t),
        calib_cam=jnp.asarray(np.concatenate([q_ic / np.linalg.norm(q_ic), 0.02 * rng.normal(size=3)])),
        cam_zeta=jnp.asarray(RADTAN_ZETA + 0.5 * rng.normal(size=8) * np.array([1, 1, 1, 1, 1e-3, 1e-3, 1e-4, 1e-4])),
        calib_dt=jnp.asarray(0.004 * rng.normal()), last_dt=jnp.asarray(0.003 * rng.normal()),
    )


def port_state(jstates, lay):
    arrays = [{f.name: np.asarray(getattr(s, f.name)) for f in dataclasses.fields(s) if f.name != "layout"}
              for s in jstates]
    return convert.state_from_arrays(convert.stack_streams(arrays), lay, device="cpu")


# --------------------------------------------------------------------------- ekf


def test_augment_clone_timeoffset():
    rng = np.random.default_rng(21)
    jlay, lay = layouts()
    B, D = 3, lay.dim
    A = rng.normal(size=(B, D, D))
    cov = A @ A.transpose(0, 2, 1) / D + 1e-3 * np.eye(D)
    slots = np.array([0, 3, K_CLONES - 1])
    dst = lay.clone_base + 6 * slots
    dnc = rng.normal(size=(B, 6))
    out = ekf.augment_clone_timeoffset(t(cov), torch.as_tensor(dst), t(dnc), lay.dt_idx)
    for b in range(B):
        close(out[b], j_ekf.augment_clone_timeoffset(cov[b], dst[b], dnc[b], jlay.dt_idx))
        # P' = A P Aᵀ with A = I + (dnc at the clone rows)·e_dtᵀ: still PSD.
        assert np.linalg.eigvalsh(out[b].numpy()).min() > 0.0
    # The clone's own block carries the quadratic term dnc·P_dt,dt·dncᵀ.
    b, c = 1, dst[1]
    quad = out[b, c:c + 6, c:c + 6].numpy() - cov[b, c:c + 6, c:c + 6]
    lin = np.outer(dnc[b], cov[b, lay.dt_idx, c:c + 6])
    close(t(quad), lin + lin.T + cov[b, lay.dt_idx, lay.dt_idx] * np.outer(dnc[b], dnc[b]))


@pytest.mark.parametrize("dt,pose,intr", FLAGS, ids=["".join("DPI"[i] if f else "-" for i, f in enumerate(c))
                                                      for c in FLAGS])
def test_apply_dx_calibration(dt, pose, intr):
    rng = np.random.default_rng(22)
    jlay, lay = layouts(dt, pose, intr)
    states = [jax_state(rng, jlay, 4) for _ in range(2)]
    dx = 1e-2 * rng.normal(size=(2, lay.dim))
    out = ekf.apply_dx(port_state(states, lay), t(dx))
    for b, s in enumerate(states):
        ref = j_ekf.apply_dx(s, dx[b])
        for name in ("imu", "calib_dt", "calib_cam", "cam_zeta", "clones_q", "clones_p", "slam_p", "plane_cp"):
            close(getattr(out, name)[b], getattr(ref, name))


# --------------------------------------------------------------------------- jacobians


@pytest.mark.parametrize("rep", [reps.GLOBAL_3D, reps.ANCHORED_MSCKF_INVERSE_DEPTH], ids=["global_3d", "anchored"])
def test_feature_jacobian_calibration_columns(rep):
    rng = np.random.default_rng(23)
    jlay, lay = layouts()
    K, D, M = jlay.max_clones, jlay.dim, 4
    states = [jax_state(rng, jlay, K) for _ in range(2)]
    uv = rng.uniform(100, 600, size=(2, M, K, 2))
    mask = rng.uniform(size=(2, M, K)) < 0.7
    mask[:, :, 0] = True
    p_f = rng.normal(size=(2, M, 3)) + np.array([0.0, 0.0, 3.0])
    p_fej = p_f + 1e-3 * rng.normal(size=p_f.shape)
    anchor = rng.integers(0, K, size=(2, M))
    opts = jac.JacobianOptions(cam_model=cams.RADTAN, do_calib_camera_pose=True, do_calib_camera_intrinsics=True,
                               rep=rep)
    kw = {} if rep == reps.GLOBAL_3D else {"anchor_slot": torch.as_tensor(anchor)}
    H_x, H_f, res, _ = jac.feature_jacobian_full(lay, opts, jac.clone_set_from_state(port_state(states, lay)),
                                                 t(uv), torch.as_tensor(mask), t(p_f), t(p_fej), 1.0, **kw)
    j_opts = j_jac.JacobianOptions(cam_model=j_cams.RADTAN, do_calib_camera_pose=True,
                                   do_calib_camera_intrinsics=True, rep=rep)
    zero3 = jnp.zeros(3)
    cal = slice(lay.cam_pose_idx, lay.cam_intr_idx + 8)
    for b, s in enumerate(states):
        j_cl = j_jac.clone_set_from_state(s)
        for m in range(M):
            ref = j_jac.feature_jacobian_full(jlay, j_opts, j_cl, uv[b, m], mask[b, m], p_f[b, m], p_fej[b, m],
                                              zero3, zero3, False, False, 0, 1.0, 0.05,
                                              anchor_slot=int(anchor[b, m]))
            for a, r in zip((H_x, H_f, res), ref[:3]):
                close(a[b, m], r, rtol=1e-10, atol=1e-8)
            assert np.abs(np.asarray(ref[0])[:, cal]).max() > 1.0  # the calibration columns are filled


# --------------------------------------------------------------------------- propagator


def test_propagate_and_clone_with_time_offset():
    rng = np.random.default_rng(24)
    jlay, lay = layouts()
    states = [jax_state(rng, jlay, n) for n in (3, K_CLONES - 1)]
    I, dt = 64, 1.0 / 400
    imu_t, imu_w, imu_a, t_new = [], [], [], []
    for b, s in enumerate(states):
        t0 = float(s.t)
        tt = t0 - 6.3 * dt + dt * np.arange(I)
        tt[52 + 3 * b:] = np.inf
        imu_t.append(tt)
        imu_w.append(0.3 * rng.normal(size=(I, 3)))
        imu_a.append(np.array([0.0, 0.0, 9.81]) + rng.normal(size=(I, 3)))
        t_new.append(t0 + 0.1 - 0.004 * b)
    noises = np.array([1.7e-4, 2e-3, 1.9e-5, 3e-3]) ** 2
    gravity = np.array([0.0, 0.0, 9.81])
    out, slot = prop.propagate_and_clone(port_state(states, lay), t(np.stack(imu_t)), t(np.stack(imu_w)),
                                         t(np.stack(imu_a)), t(np.array(t_new)), t(noises), t(gravity),
                                         prop.PropagatorOptions(do_calib_camera_timeoffset=True))
    j_opts = j_prop.PropagatorOptions(do_calib_camera_timeoffset=True)
    for b, s in enumerate(states):
        ref, j_slot = j_prop.propagate_and_clone(s, imu_t[b], imu_w[b], imu_a[b], t_new[b], noises, gravity, j_opts)
        assert int(slot[b]) == int(j_slot)
        for name in ("t", "last_dt", "imu", "imu_fej", "cov", "clones_q", "clones_p", "clones_t"):
            close(getattr(out, name)[b], getattr(ref, name), rtol=1e-10, atol=1e-12)
        c = lay.clone_base + 6 * int(slot[b])
        assert np.abs(out.cov[b, lay.dt_idx, c:c + 6].numpy()).max() > 0.0  # the clone couples to dt


# --------------------------------------------------------------------------- run_sequence


def _configure(cfg):
    """tests/test_calib.py's settings with all three calibration blocks on."""
    cfg.sim.traj_duration = 20.0
    cfg.state.max_slam_features = 0
    cfg.state.use_plane_constraint = False
    cfg.state.use_plane_slam_feats = False
    cfg.state.do_calib_camera_pose = True
    cfg.state.do_calib_camera_intrinsics = True
    cfg.state.do_calib_camera_timeoffset = True
    cfg.num_pts = 50
    cfg.num_pts_plane = 0
    cfg.tpu.max_features = 160
    cfg.tpu.max_obs_per_frame = 80
    cfg.tpu.max_msckf_update = 40
    return cfg


def estimator_config(cfg, zeta, ext):
    """The filter's view: perturbed intrinsics and extrinsics, dt = 0."""
    cfg = dataclasses.replace(cfg)
    cfg.cam_intrinsics = [float(x) for x in zeta]
    cfg.cam_extrinsics = [float(x) for x in ext]
    cfg.calib_camimu_dt = 0.0
    return cfg


@pytest.fixture(scope="module")
def calib_run():
    """Two noisy draws of the calibration scene (15 ms offset) through the JAX
    run_sequence, cut to N_FRAMES + 1 frames."""
    cfg = _configure(j_sim_config())
    cfg.calib_camimu_dt = 0.015
    sim = j_build_sim(cfg, max_obs=cfg.tpu.max_obs_per_frame)
    _, zeta, ext = j_perturb(cfg, seed=1)
    cfg_est = estimator_config(cfg, zeta, ext)
    noise = JNoise(sigma_w=cfg.imu_noises.sigma_w, sigma_a=cfg.imu_noises.sigma_a,
                   sigma_wb=cfg.imu_noises.sigma_wb, sigma_ab=cfg.imu_noises.sigma_ab,
                   sigma_pix=cfg.msckf_options.sigma_pix, dt_imu=1.0 / cfg.sim.freq_imu)
    cam_fields = ("cam_t", "cam_t_imu", "obs_id", "obs_uv", "obs_uv_true", "obs_plane", "obs_gt_p",
                  "obs_gt_cp", "imu_window_start", "gt_q", "gt_p", "gt_v", "gt_bg_cam", "gt_ba_cam")
    eng = JEngine.from_config(cfg_est)
    streams, refs = [], []
    for seed in SEEDS:
        s = j_apply_noise(sim, jax.random.PRNGKey(seed), noise)
        s = s._replace(**{k: getattr(s, k)[:N_FRAMES + 1] for k in cam_fields})
        st = j_init(eng, cfg_est, t0=s.cam_t[0], q0=s.gt_q[0], p0=s.gt_p[0], v0=s.gt_v[0],
                    bg0=s.gt_bg_cam[0], ba0=s.gt_ba_cam[0])
        bank = JBank.create(cfg.tpu.max_features, eng.layout.max_clones)
        refs.append(j_run(eng, st, bank, s, imu_window=cfg.tpu.max_imu_per_frame))
        streams.append({k: np.asarray(v) for k, v in s._asdict().items()})
    return zeta, ext, streams, refs


def test_calibration_run_matches_jax(calib_run):
    zeta, ext, streams, refs = calib_run
    cfg = estimator_config(_configure(sim_config()), zeta, ext)
    eng = VioEngine.from_config(cfg, device="cpu")
    assert eng.layout.dim == 15 + 1 + 6 + 8 + 6 * eng.layout.max_clones + 3 + 3 * eng.layout.max_planes
    sim = convert.sim_from_streams(streams, device="cpu")
    B = len(streams)
    state = init_state_with_gt(eng, cfg, t0=sim.cam_t[0].expand(B), q0=sim.gt_q[0].expand(B, 4),
                               p0=sim.gt_p[0].expand(B, 3), v0=sim.gt_v[0].expand(B, 3),
                               bg0=sim.gt_bg_cam[:, 0], ba0=sim.gt_ba_cam[:, 0], device="cpu")
    bank = FeatureBank.create(cfg.tpu.max_features, eng.layout.max_clones, batch=B, device="cpu")
    state, _, outs = run_sequence(eng, state, bank, sim, imu_window=cfg.tpu.max_imu_per_frame)
    assert outs.p.shape == (B, N_FRAMES, 3)
    for b, (j_state, _, j_outs) in enumerate(refs):
        for name in ("n_msckf_used", "n_bank", "n_clones", "n_slam", "n_planes"):
            np.testing.assert_array_equal(getattr(outs, name)[b].numpy(), np.asarray(getattr(j_outs, name)),
                                          err_msg=name)
        close(outs.p[b], j_outs.p, rtol=0, atol=1e-6)
        close(outs.q[b], j_outs.q, rtol=0, atol=1e-6)
        close(state.calib_dt[b], j_state.calib_dt, rtol=0, atol=1e-9)
        close(state.calib_cam[b], j_state.calib_cam, rtol=0, atol=1e-7)
        close(state.cam_zeta[b], j_state.cam_zeta, rtol=0, atol=1e-5)
    # The comparison covers real updates that moved every calibration block.
    assert int(outs.n_msckf_used.sum()) > 50
    assert float(state.calib_dt.abs().min()) > 1e-4
    assert float((state.cam_zeta - torch.as_tensor(zeta)).abs().max()) > 1e-3


def convergence_table(n_frames: int = 120, streams: int = 16, checkpoints=(26, 40, 60, 90, 120)):
    """The calibration errors' fall over the perturbations of seeds 1..streams
    (the card's calibration phase starts stream b from seed 1 + b), JAX and
    the port on the same noisy draws (JAX ``apply_noise``, key b): the mean
    over streams of the intrinsics error ‖(fx, fy, cx, cy) − truth‖ and of
    |dt − 15 ms|, each over its start, at each checkpoint frame."""
    from ov_plane_tpu.models.manager import FrameData as JFrame
    from ov_plane_tpu.models.manager import step as j_step

    cfg = _configure(j_sim_config())
    cfg.calib_camimu_dt = 0.015
    cfg.tpu.use_info_compression = True
    scene = j_build_sim(cfg, max_obs=cfg.tpu.max_obs_per_frame)
    noise = JNoise(sigma_w=cfg.imu_noises.sigma_w, sigma_a=cfg.imu_noises.sigma_a,
                   sigma_wb=cfg.imu_noises.sigma_wb, sigma_ab=cfg.imu_noises.sigma_ab,
                   sigma_pix=cfg.msckf_options.sigma_pix, dt_imu=1.0 / cfg.sim.freq_imu)
    zt, W = np.asarray(cfg.cam_intrinsics), cfg.tpu.max_imu_per_frame
    stepj = jax.jit(j_step, static_argnums=0)
    pert = [j_perturb(cfg, seed=1 + b) for b in range(streams)]
    draws = [j_apply_noise(scene, jax.random.PRNGKey(b), noise) for b in range(streams)]
    errs = {"JAX": np.zeros((streams, n_frames, 2)), "port": np.zeros((streams, n_frames, 2))}
    for b, (s, (_, zeta, ext)) in enumerate(zip(draws, pert)):
        ce = estimator_config(cfg, zeta, ext)
        eng = JEngine.from_config(ce)
        st = j_init(eng, ce, t0=s.cam_t[0], q0=s.gt_q[0], p0=s.gt_p[0], v0=s.gt_v[0], bg0=s.gt_bg_cam[0],
                    ba0=s.gt_ba_cam[0])
        bk = JBank.create(cfg.tpu.max_features, eng.layout.max_clones)
        for i in range(1, n_frames + 1):
            w0 = int(s.imu_window_start[i])
            st, bk, _ = stepj(eng, st, bk, JFrame(
                imu_t=s.imu_t[w0:w0 + W], imu_w=s.imu_w[w0:w0 + W], imu_a=s.imu_a[w0:w0 + W], t_new=s.cam_t[i],
                obs_id=s.obs_id[i], obs_uv=s.obs_uv[i], obs_plane=s.obs_plane[i]))
            errs["JAX"][b, i - 1] = (np.linalg.norm(np.asarray(st.cam_zeta[:4]) - zt[:4]),
                                     abs(float(st.calib_dt) - 0.015))
    pcfg = _configure(sim_config())
    pcfg.tpu.use_info_compression = True
    sim = convert.sim_from_streams([{k: np.asarray(v) for k, v in s._asdict().items()} for s in draws], device="cpu")
    st = init_state_with_gt(VioEngine.from_config(estimator_config(pcfg, *pert[0][1:]), device="cpu"),
                            estimator_config(pcfg, *pert[0][1:]), t0=sim.cam_t[0].expand(streams),
                            q0=sim.gt_q[0].expand(streams, 4), p0=sim.gt_p[0].expand(streams, 3),
                            v0=sim.gt_v[0].expand(streams, 3), bg0=sim.gt_bg_cam[:, 0], ba0=sim.gt_ba_cam[:, 0],
                            device="cpu")
    st = st.replace(cam_zeta=t(np.stack([p[1] for p in pert])), calib_cam=t(np.stack([p[2] for p in pert])))
    eng = VioEngine.from_config(estimator_config(pcfg, *pert[0][1:]), device="cpu")
    bank = FeatureBank.create(pcfg.tpu.max_features, eng.layout.max_clones, batch=streams, device="cpu")
    for i in range(1, n_frames + 1):
        st, bank, _ = run_sequence(eng, st, bank, sim, imu_window=W, n_frames=1, start=i)
        errs["port"][:, i - 1, 0] = torch.linalg.vector_norm(st.cam_zeta[:, :4] - t(zt[:4]), dim=1).numpy()
        errs["port"][:, i - 1, 1] = (st.calib_dt - 0.015).abs().numpy()
    e0 = np.array([np.linalg.norm(p[1][:4] - zt[:4]) for p in pert])
    for name, e in errs.items():
        for f in checkpoints:
            if f <= n_frames:
                print(f"{name} frame {f}: intrinsics mean error / mean start {e[:, f - 1, 0].mean() / e0.mean():.3f} "
                      f"(mean of ratios {(e[:, f - 1, 0] / e0).mean():.3f}), |dt| mean error / 15 ms "
                      f"{e[:, f - 1, 1].mean() / 0.015:.3f}")
    return errs


if __name__ == "__main__":
    # The calibration phase's bounds: the errors' fall over 16 perturbations,
    # JAX and the port (env JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_calib.py).
    jax.config.update("jax_enable_x64", True)
    torch.set_num_threads(4)
    convergence_table()
