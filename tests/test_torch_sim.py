"""The port's simulator against the JAX package's (float64 on the CPU).

* ``ops/spline``: ``fit_spline``'s control poses within 1e-12; ``pose``
  within 1e-12, ``velocity`` and ``acceleration`` within 1e-9 of their
  largest magnitude, at random times, at segment edges and over a hovering
  segment (exactly-zero twists: the nested derivatives stay finite);
* ``sim/trajectory``: every procedural kind, ``world_offset`` and a loaded
  txt with ``traj_start`` (times and positions equal, quaternions 1e-14);
* ``generate_planes`` equal, ``perturb_calibration`` equal (its quaternion 1e-15);
* the feature map: fed JAX's own pose samples, identical; end to end, the
  same plane ids with positions within 1e-12;
* ``build_sim`` against each of the five committed scenes (ids and plane
  ids equal, floats within 1e-9) and against a fresh JAX ``build_sim`` of a
  corridor scene, a kind no committed scene has (every noiseless field);
* ``render_frame`` and the blob overlay of ``render_frame_textured`` within 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ov_plane_tpu.frontend import synthetic as j_syn
from ov_plane_tpu.ops import spline as j_sp
from ov_plane_tpu.ops.quat import quat_2_rot as j_quat_2_rot
from ov_plane_tpu.sim import simulator as j_sim
from ov_plane_tpu.sim import trajectory as j_traj
from ov_plane_tpu.utils.config import sim_config as j_sim_config
from ov_plane_tpu_torch.frontend import synthetic as syn
from ov_plane_tpu_torch.ops import spline as sp
from ov_plane_tpu_torch.sim import simulator as sim
from ov_plane_tpu_torch.sim import trajectory as traj
from ov_plane_tpu_torch.utils.config import VioConfig
from test_torch_scene import (FIELDS, PLANE_FIELDS, VISION_FIELDS, _bench_cfg, _plane_cfg, _tabletop_cfg,
                              _tabletop_replay_cfg, _vision_cfg)

TRUTH_FIELDS = ("imu_t", "imu_w_true", "imu_a_true", "cam_t", "cam_t_imu", "obs_id", "obs_uv_true", "obs_plane",
                "obs_gt_p", "obs_gt_cp", "imu_window_start", "gt_q", "gt_p", "gt_v", "feat_p", "feat_plane",
                "plane_cp")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_config(jcfg) -> VioConfig:
    """The port's VioConfig with the JAX configuration's values."""
    cfg = VioConfig()
    for f in dataclasses.fields(VioConfig):
        v = getattr(jcfg, f.name)
        if dataclasses.is_dataclass(v):
            sec = getattr(cfg, f.name)
            for g in dataclasses.fields(sec):
                setattr(sec, g.name, getattr(v, g.name))
        else:
            setattr(cfg, f.name, v)
    return cfg


def host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# --------------------------------------------------------------------------- spline


def _hovering_scan():
    """A 4 s room scan whose samples hold still from 1.5 s to 2.5 s (duplicate control poses)."""
    t, p, q = (np.array(a) for a in j_traj.room_scan_trajectory(duration=4.0))
    hold = (t >= 1.5) & (t <= 2.5)
    i0 = np.nonzero(hold)[0][0]
    p[hold], q[hold] = p[i0], q[i0]
    return t, p, q


@pytest.mark.parametrize("kind", ["room_scan", "hovering"])
def test_spline_matches_jax(kind):
    t, p, q = (np.array(a) for a in j_traj.room_scan_trajectory(duration=4.0)) if kind == "room_scan" \
        else _hovering_scan()
    jspl = j_sp.fit_spline(jnp.asarray(t), jnp.asarray(q), jnp.asarray(p))
    spl = sp.fit_spline(torch.as_tensor(t), torch.as_tensor(q), torch.as_tensor(p))
    for a, b in zip(spl, jspl):
        np.testing.assert_allclose(host(a), np.asarray(b), rtol=0, atol=1e-12)
    if kind == "hovering":
        assert (np.abs(host(spl.omegas)).max(axis=1) == 0).sum() > 50
    rng = np.random.default_rng(3)
    n = spl.ctrl_R.shape[0]
    edges = float(spl.t0) + float(spl.dt) * np.arange(1, n - 3)
    ts = np.concatenate([rng.uniform(float(spl.start_time), float(spl.end_time), 200), edges[::7],
                         np.linspace(1.4, 2.6, 40)])
    tt = torch.as_tensor(ts)
    jt = jnp.asarray(ts)
    R, pp = sp.pose(spl, tt)
    jR, jp = jax.vmap(lambda x: j_sp.pose(jspl, x))(jt)
    np.testing.assert_allclose(host(R), np.asarray(jR), rtol=0, atol=1e-12)
    np.testing.assert_allclose(host(pp), np.asarray(jp), rtol=0, atol=1e-12)
    port = sp.acceleration(spl, tt)
    ref = jax.vmap(lambda x: j_sp.acceleration(jspl, x))(jt)
    vel = sp.velocity(spl, tt)
    jvel = jax.vmap(lambda x: j_sp.velocity(jspl, x))(jt)
    for a, b in list(zip(port, ref))[2:] + list(zip(vel, jvel))[2:]:
        a, b = host(a), np.asarray(b)
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9 * np.abs(b).max())


# --------------------------------------------------------------------------- trajectories


@pytest.mark.parametrize("kind,offset", [("room_scan", (0, 0, 0)), ("slow_scan", (0, 0, 0)),
                                         ("corridor", (0, 0, 0)), ("tabletop", (0, 0, 0)),
                                         ("room_scan", (3.5, -2.0, 1.25))])
def test_procedural_trajectory_matches_jax(kind, offset):
    jcfg = j_sim_config()
    jcfg.sim.traj_duration, jcfg.sim.traj_kind, jcfg.sim.world_offset = 7.0, kind, offset
    a, b = traj.get_trajectory(port_config(jcfg).sim), j_traj.get_trajectory(jcfg.sim)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_allclose(a[2], b[2], rtol=0, atol=1e-14)


def test_loaded_trajectory_matches_jax(tmp_path):
    t, p, q = j_traj.corridor_trajectory(duration=12.0)
    path = tmp_path / "traj.txt"
    np.savetxt(path, np.column_stack([1.55e9 + t[::2], p[::2] + 1.0, q[::2]]),
               header="timestamp(s) tx ty tz qx qy qz qw")
    jcfg = j_sim_config()
    jcfg.sim.traj_path, jcfg.sim.traj_start, jcfg.sim.traj_duration = str(path), 2.5, 6.0
    a, b = traj.get_trajectory(port_config(jcfg).sim), j_traj.get_trajectory(jcfg.sim)
    assert 2.5 <= a[0][0] < 2.6 and a[0][-1] - a[0][0] <= 6.0
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


# --------------------------------------------------------------------------- planes, calibration, map


def test_generate_planes_and_perturb_calibration_match_jax():
    _, pos, _ = j_traj.room_scan_trajectory(duration=9.0)
    a, b = sim.generate_planes(pos.copy(), 2.0), j_sim.generate_planes(pos.copy(), 2.0)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    jcfg = j_sim_config()
    for seed in (0, 3):
        (dt, zeta, ext), (jdt, jzeta, jext) = (sim.perturb_calibration(port_config(jcfg), seed),
                                               j_sim.perturb_calibration(jcfg, seed))
        assert dt == jdt
        np.testing.assert_array_equal(zeta, jzeta)
        np.testing.assert_array_equal(ext[4:], jext[4:])
        np.testing.assert_allclose(ext[:4], jext[:4], rtol=0, atol=1e-15)


def _map_inputs(jcfg):
    """The JAX spline, planes and map window of ``build_sim``."""
    times, pos, quat = j_traj.get_trajectory(jcfg.sim)
    jspl = j_sp.fit_spline(jnp.asarray(times), jnp.asarray(quat), jnp.asarray(pos))
    t_start = j_sim._find_start_time(jspl, jcfg.sim.freq_cam, jcfg.sim.distance_threshold)
    t_end = float(jspl.end_time) - 2.0 * float(jspl.dt)
    planes = j_sim.generate_planes(pos, jcfg.sim.min_feature_gen_distance)
    return (times, pos, quat), jspl, planes, t_start, t_end


@pytest.mark.parametrize("make", [_plane_cfg, _tabletop_cfg], ids=["m_pl", "tabletop"])
def test_feature_map_matches_jax(make):
    jcfg = make()
    (times, pos, quat), jspl, planes, t_start, t_end = _map_inputs(jcfg)
    ref_p, ref_plane = j_sim.build_feature_map(jcfg, jspl, planes, t_start, t_end, jcfg.sim.seed_state_init)
    cfg = port_config(jcfg)
    # Fed JAX's own pose samples: the same map, bit for bit.
    R, p = jax.jit(jax.vmap(lambda t: j_sp.pose(jspl, t)))(jnp.asarray(np.arange(t_start, t_end, 0.25)))
    port_planes = sim.SimPlanes(*planes)
    fp, fplane = sim.feature_map_from_poses(cfg, np.asarray(R), np.asarray(p), port_planes, cfg.sim.seed_state_init)
    np.testing.assert_array_equal(fp, ref_p)
    np.testing.assert_array_equal(fplane, ref_plane)
    # End to end: the port's spline and start time.
    spl = sp.fit_spline(torch.as_tensor(times), torch.as_tensor(quat), torch.as_tensor(pos))
    assert sim._find_start_time(spl, cfg.sim.freq_cam, cfg.sim.distance_threshold) == t_start
    fp, fplane = sim.build_feature_map(cfg, spl, port_planes, t_start, t_end, cfg.sim.seed_state_init)
    np.testing.assert_array_equal(fplane, ref_plane)
    np.testing.assert_allclose(fp, ref_p, rtol=0, atol=1e-12)
    assert (ref_plane >= 0).any() == (jcfg.num_pts_plane > 0)


# --------------------------------------------------------------------------- build_sim


@pytest.mark.parametrize("path,make,fields", [
    (sim.SCENE_PATH, _bench_cfg, FIELDS), (sim.PLANE_SCENE_PATH, _plane_cfg, PLANE_FIELDS),
    (sim.VISION_SCENE_PATH, _vision_cfg, VISION_FIELDS), (sim.TABLETOP_SCENE_PATH, _tabletop_cfg, VISION_FIELDS),
    (sim.TABLETOP_REPLAY_SCENE_PATH, _tabletop_replay_cfg, VISION_FIELDS)],
    ids=["bench", "m_pl", "vision", "tabletop", "tabletop_replay"])
def test_build_sim_reproduces_committed_scene(path, make, fields):
    jcfg = make()
    truth = sim.build_sim(port_config(jcfg), max_obs=jcfg.tpu.max_obs_per_frame, device="cpu")
    with np.load(path) as z:
        for k in fields:
            a = host(getattr(truth, k))
            assert a.shape == z[k].shape, k
            if np.issubdtype(z[k].dtype, np.integer):
                np.testing.assert_array_equal(a, z[k], err_msg=k)
            else:
                np.testing.assert_allclose(a, z[k], rtol=0, atol=1e-9, err_msg=k)


@pytest.fixture(scope="module")
def corridor():
    """A fresh corridor scene from both packages (8 s, 30 free + 30 plane points)."""
    jcfg = j_sim_config()
    jcfg.sim.traj_kind, jcfg.sim.traj_duration, jcfg.sim.world_offset = "corridor", 8.0, (1.0, -0.5, 0.25)
    jcfg.num_pts, jcfg.num_pts_plane = 30, 30
    jcfg.tpu.max_obs_per_frame = 64
    ref = j_sim.build_sim(jcfg, max_obs=64)
    return jcfg, ref, sim.build_sim(port_config(jcfg), max_obs=64, device="cpu")


def test_build_sim_matches_fresh_jax_corridor(corridor):
    _, ref, truth = corridor
    for k in TRUTH_FIELDS:
        a, b = host(getattr(truth, k)), np.asarray(getattr(ref, k))
        assert a.shape == b.shape, k
        if np.issubdtype(b.dtype, np.integer):
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-9, err_msg=k)
    assert (host(truth.obs_plane) >= 0).any() and (host(truth.obs_id) >= 0).sum() > 1000
    # The carried-across JAX draw keeps the scene and its noise.
    from ov_plane_tpu_torch import convert

    arrays = {k: np.asarray(v) for k, v in ref._asdict().items()}
    noisy = convert.sim_from_arrays(arrays, device="cpu")
    np.testing.assert_array_equal(noisy.imu_w[0].numpy(), arrays["imu_w"])
    np.testing.assert_array_equal(noisy.obs_id.numpy(), arrays["obs_id"])
    scene = convert.sim_from_arrays(arrays, noisy=False, device="cpu")
    np.testing.assert_array_equal(scene.feat_plane.numpy(), arrays["feat_plane"])


# --------------------------------------------------------------------------- renderer


def test_render_frame_and_blob_overlay_match_jax(corridor):
    jcfg, ref, truth = corridor
    zeta = np.asarray(jcfg.cam_intrinsics)
    R_ItoC, p_IinC = np.eye(3), np.zeros(3)
    planes = j_sim.generate_planes(j_traj.get_trajectory(jcfg.sim)[1], jcfg.sim.min_feature_gen_distance)
    feat_p = np.asarray(ref.feat_p)
    for k in (0, 25, 60):
        R = np.array(j_quat_2_rot(ref.gt_q[k]))
        p = np.array(ref.gt_p[k])
        a = j_syn.render_frame(feat_p, R, p, R_ItoC, p_IinC, zeta, jcfg.cam_wh)
        b = syn.render_frame(truth.feat_p, R, p, R_ItoC, p_IinC, zeta, jcfg.cam_wh).numpy()
        assert (a > 0.12).sum() > 1000
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)
        a = j_syn.render_frame_textured(planes.corners, planes.normal, planes.d, feat_p, R, p, R_ItoC, p_IinC,
                                        zeta, jcfg.cam_wh, texture_cell=0.1, speckle_cells=((0.05, 0.12, 0.30), 0.12))
        b = syn.render_frame_textured(truth.plane_corners, truth.plane_normal, truth.plane_d, R, p, R_ItoC, p_IinC,
                                      zeta, jcfg.cam_wh, texture_cell=0.1, speckle_cells=((0.05, 0.12, 0.30), 0.12),
                                      feat_p=truth.feat_p).numpy()
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)
