"""Data parallelism over processes: the port's dp-sharded ``batched_replay``
and dp-sharded ``FusedVisionDriver`` (2 gloo processes × 2 streams) against
one process × 4 streams and against the JAX package's single-process
oracles of ``tests/test_distributed.py`` (:33 the replay, :103 the fused
driver).

The workers are this file run as ``python tests/test_torch_distributed.py
worker ...`` (``test_torch_parallel.Workers``: a free port, a time limit,
killed on expiry). The JAX oracles need the JAX ``build_sim`` and two
compiles, so their inputs and outputs are committed in
``tests/data/torch_distributed_jax.npz``; regenerate it with

    env JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_distributed.py

(about a minute).
"""

import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_parallel import Workers  # noqa: E402

from ov_plane_tpu_torch import convert  # noqa: E402
from ov_plane_tpu_torch.models.feature_bank import FeatureBank  # noqa: E402
from ov_plane_tpu_torch.models.manager import VioEngine, init_state_with_gt  # noqa: E402
from ov_plane_tpu_torch.utils import config as tconfig  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
REFERENCE = ROOT / "tests" / "data" / "torch_distributed_jax.npz"
B_GLOBAL, N_FRAMES = 4, 4         # tests/helpers/dist_fused_config.py
SEEDS = (1, 2, 3, 4)              # the replay's four JAX noise draws


def replay_config(cfg):
    """tests/helpers/dist_replay_config.py's configuration."""
    cfg.sim.traj_duration = 5.0
    cfg.state.max_slam_features = 0
    cfg.state.do_calib_camera_pose = False
    cfg.state.do_calib_camera_intrinsics = False
    cfg.state.do_calib_camera_timeoffset = False
    cfg.num_pts = 20
    cfg.num_pts_plane = 0
    cfg.tpu.max_features = 64
    cfg.tpu.max_obs_per_frame = 48
    cfg.tpu.max_msckf_update = 24
    return cfg


def fused_config(cfg):
    """tests/helpers/dist_fused_config.py's configuration."""
    replay_config(cfg)
    cfg.state.use_plane_constraint = False
    cfg.state.use_plane_slam_feats = False
    cfg.num_pts = 30
    cfg.cam_wh = [256, 192]
    cfg.cam_intrinsics = [160.0, 160.0, 128.0, 96.0, 0.0, 0.0, 0.0, 0.0]
    cfg.histogram_method = "NONE"
    cfg.tpu.max_msckf_update = 16
    return cfg


def _arrays(ref, pre):
    return {k[len(pre):]: ref[k] for k in ref if k.startswith(pre)}


def replay_setup(ref):
    """The replay's engine, its 4-stream scene (the JAX draws) and a fresh state and bank of 4 streams."""
    cfg = replay_config(tconfig.sim_config())
    eng = VioEngine.from_config(cfg, device="cpu")
    scene = _arrays(ref, "replay_scene_")
    sim = convert.sim_from_streams([dict(scene, **_arrays(ref, f"replay_draw{s}_")) for s in SEEDS], device="cpu")
    b = B_GLOBAL
    state = init_state_with_gt(eng, cfg, t0=sim.cam_t_imu[0].expand(b), q0=sim.gt_q[0].expand(b, 4),
                               p0=sim.gt_p[0].expand(b, 3), v0=sim.gt_v[0].expand(b, 3), bg0=sim.gt_bg_cam[:, 0],
                               ba0=sim.gt_ba_cam[:, 0], device="cpu")
    return eng, cfg, sim, state, FeatureBank.create(cfg.tpu.max_features, eng.layout.max_clones, b, device="cpu")


def fused_inputs(ref):
    """The fused test's config, scene, frames [N][4, h, w] (the JAX base frames
    plus tests/helpers' per-stream noise) and IMU windows."""
    cfg = fused_config(tconfig.sim_config())
    sim = convert.sim_from_arrays(_arrays(ref, "fused_sim_"), device="cpu")
    noise = np.random.default_rng(3).normal(0.0, 0.01, (B_GLOBAL, cfg.cam_wh[1], cfg.cam_wh[0])).astype(np.float32)
    frames = [np.clip(base[None] + noise, 0.0, 1.0) for base in ref["fused_base_frames"]]
    W = cfg.tpu.max_imu_per_frame
    imu_t, imu_w, imu_a = (x.numpy() for x in (sim.imu_t, sim.imu_w[0], sim.imu_a[0]))
    windows = []
    for i in range(1, N_FRAMES + 1):
        s0 = int(sim.imu_window_start[i])
        m = len(imu_t[s0:s0 + W])
        it, iw, ia = np.full(W, np.inf), np.zeros((W, 3)), np.zeros((W, 3))
        it[:m], iw[:m], ia[:m] = imu_t[s0:s0 + W], imu_w[s0:s0 + W], imu_a[s0:s0 + W]
        windows.append((np.tile(it, (B_GLOBAL, 1)), np.tile(iw, (B_GLOBAL, 1, 1)), np.tile(ia, (B_GLOBAL, 1, 1)),
                        np.full(B_GLOBAL, float(sim.cam_t_imu[i]))))
    return cfg, sim, frames, windows


def run_fused(ref, mesh=None):
    """The fused driver over the frames (this rank's slab under ``mesh``):
    per frame p, q and the pull; the last counters; the driver."""
    from ov_plane_tpu_torch.frontend.fused import FusedVisionDriver

    cfg, sim, frames, windows = fused_inputs(ref)
    eng = VioEngine.from_config(cfg, device="cpu")
    drv = FusedVisionDriver(cfg, eng, B_GLOBAL, mesh=mesh)
    sl = slice(drv.batch_lo, drv.batch_lo + drv.B)
    b = drv.B
    st = init_state_with_gt(eng, cfg, t0=sim.cam_t_imu[0].expand(b), q0=sim.gt_q[0].expand(b, 4),
                            p0=sim.gt_p[0].expand(b, 3), v0=sim.gt_v[0].expand(b, 3),
                            bg0=sim.gt_bg_cam[0, 0].expand(b, 3), ba0=sim.gt_ba_cam[0, 0].expand(b, 3), device="cpu")
    bank = FeatureBank.create(cfg.tpu.max_features, eng.layout.max_clones, b, device="cpu")
    fev = drv.init_frontend()
    out = dict(p=[], q=[], pull=[])
    for i in range(N_FRAMES):
        st, bank, fev, o = drv.step_batch(st, bank, fev, frames[i][sl], *(w[sl] for w in windows[i]))
        out["p"].append(o.p.numpy().copy())
        out["q"].append(o.q.numpy().copy())
        out["pull"].append(drv._pending[0].numpy().copy())
    drv.flush_stream()
    res = {k: np.stack(v, axis=1 if k != "pull" else 0) for k, v in out.items()}
    res.update(counters=drv.last_counters.copy(), batch_lo=drv.batch_lo, n_local=drv.B)
    return res


# ----------------------------------------------------------------------
def worker_dp(rank: int, world: int, out: Path):
    """The dp-sharded replay ('seq') and the dp-sharded fused driver ('dp')."""
    from ov_plane_tpu_torch.parallel import distributed
    from ov_plane_tpu_torch.parallel.replay import batched_replay, make_mesh, shard_leading_axis

    with np.load(REFERENCE) as z:
        ref = {k: z[k] for k in z.files}
    mesh = make_mesh(axis="seq")
    eng, cfg, sim, state, bank = replay_setup(ref)
    outs, rmse = batched_replay(eng, shard_leading_axis(state, mesh), shard_leading_axis(bank, mesh), sim,
                                cfg.tpu.max_imu_per_frame, mesh)
    res = dict(replay_p=outs.p.numpy(), replay_q=outs.q.numpy(), replay_n_msckf_used=outs.n_msckf_used.numpy(),
               replay_rmse=rmse.numpy(), world=mesh.size())
    fmesh = distributed.global_mesh(("dp",))
    res.update({f"fused_{k}": v for k, v in run_fused(ref, fmesh).items()})
    np.savez(out / f"dp_{rank}.npz", **res)


WORKERS = {"dp": worker_dp}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference():
    with np.load(REFERENCE) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def workers(tmp_path_factory):
    job = Workers(Path(__file__), "dp", tmp_path_factory.mktemp("dp"))
    yield job
    job.kill()


def test_dp_replay_matches_one_process_and_jax(workers, reference):
    """test_distributed.py:33: 4 streams (four JAX noise draws) over 2
    processes × 2 streams against one process × 4 and JAX's per-stream
    replays: every stream's trajectory, and the fleet RMSE (the one
    collective) the same bits on both ranks, equal to the one-process value
    and to JAX's."""
    from ov_plane_tpu_torch.parallel.replay import batched_replay

    eng, cfg, sim, state, bank = replay_setup(reference)
    outs, rmse = batched_replay(eng, state, bank, sim, cfg.tpu.max_imu_per_frame)
    workers = workers.result()
    assert all(int(w["world"]) == 2 for w in workers)
    p_dist = np.concatenate([w["replay_p"] for w in workers])
    np.testing.assert_allclose(p_dist, outs.p.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(np.concatenate([w["replay_n_msckf_used"] for w in workers]), outs.n_msckf_used.numpy())
    np.testing.assert_array_equal(workers[1]["replay_rmse"], workers[0]["replay_rmse"])
    assert float(workers[0]["replay_rmse"]) == pytest.approx(float(rmse), rel=1e-12)
    np.testing.assert_allclose(p_dist, reference["replay_p"], rtol=0, atol=1e-6)
    assert float(rmse) == pytest.approx(float(reference["replay_rmse"]), rel=1e-6)
    assert np.isfinite(float(rmse)) and float(rmse) < 1.0
    assert np.abs(p_dist[0] - p_dist[3]).max() > 1e-6       # the draws differ: a slab mix-up would show


def test_dp_fused_driver_matches_one_process_and_jax(workers, reference):
    """test_distributed.py:103: the fused driver with a 'dp' mesh, 2
    processes × 2 streams, each hosting its slab's detector and label rows,
    against one process × 4 streams (every pull and the counters equal, the
    poses within 1e-12) and against the JAX single-process oracle (integer
    outputs equal, poses at test_torch_fused's tolerances)."""
    one = run_fused(reference)
    workers = workers.result()
    assert [int(w["fused_batch_lo"]) for w in workers] == [0, 2]
    assert [int(w["fused_n_local"]) for w in workers] == [2, 2]
    dist_ = {k: np.concatenate([w[f"fused_{k}"] for w in workers], axis=1 if k == "pull" else 0)
             for k in ("p", "q", "pull", "counters")}
    np.testing.assert_array_equal(dist_["counters"], one["counters"])
    for k in range(N_FRAMES):
        a, b = dist_["pull"][k], one["pull"][k]
        np.testing.assert_array_equal(a[..., :-3, [0, 3, 7]], b[..., :-3, [0, 3, 7]], err_msg=f"frame {k}")
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=f"frame {k}")
    np.testing.assert_allclose(dist_["p"], one["p"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(dist_["q"], one["q"], rtol=0, atol=1e-12)
    for k in range(N_FRAMES):
        jp = reference["fused_pull"][k]
        np.testing.assert_array_equal(one["pull"][k][..., :-3, [0, 3, 7]], jp[..., :-3, [0, 3, 7]], err_msg=f"frame {k}")
    np.testing.assert_array_equal(one["counters"], reference["fused_counters"])
    np.testing.assert_allclose(one["p"], reference["fused_p"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(one["q"], reference["fused_q"], rtol=0, atol=1e-5)
    assert (one["pull"][-1][:, :-3, 3] > 0.5).sum() > 40


# ----------------------------------------------------------------------
def generate() -> dict:
    """The JAX oracles: the replay scene and four noise draws with each
    draw's single-process ``run_sequence`` and their fleet RMSE; the fused
    scene, its base frames and the single-process 4-stream ``step_batch``."""
    import jax
    import jax.numpy as jnp

    from helpers.dist_fused_config import imu_window, make_cfg_sim_frames
    from helpers.dist_replay_config import make_cfg_sim
    from ov_plane_tpu.frontend.fused import FusedVisionDriver as JDriver
    from ov_plane_tpu.frontend.synthetic import render_frame
    from ov_plane_tpu.models.feature_bank import FeatureBank as JBank
    from ov_plane_tpu.models.manager import VioEngine as JEngine
    from ov_plane_tpu.models.manager import init_state_with_gt as j_init
    from ov_plane_tpu.models.manager import run_sequence as j_run
    from ov_plane_tpu.ops.quat import quat_2_rot
    from ov_plane_tpu.sim.simulator import NoiseParams, apply_noise

    jax.config.update("jax_enable_x64", True)
    out = {}
    cfg, sim = make_cfg_sim()
    eng = JEngine.from_config(cfg)
    noisy = convert.NOISY_FIELDS
    out.update({f"replay_scene_{k}": np.asarray(v) for k, v in sim._asdict().items() if v is not None and k not in noisy})
    noise = NoiseParams(sigma_w=cfg.imu_noises.sigma_w, sigma_a=cfg.imu_noises.sigma_a,
                        sigma_wb=cfg.imu_noises.sigma_wb, sigma_ab=cfg.imu_noises.sigma_ab,
                        sigma_pix=cfg.msckf_options.sigma_pix, dt_imu=1.0 / cfg.sim.freq_imu)
    run = jax.jit(lambda s, b, d: j_run(eng, s, b, d, imu_window=cfg.tpu.max_imu_per_frame))
    ps = []
    for seed in SEEDS:
        d = apply_noise(sim, jax.random.PRNGKey(seed), noise)
        out.update({f"replay_draw{seed}_{k}": np.asarray(getattr(d, k)) for k in noisy})
        st = j_init(eng, cfg, t0=d.cam_t_imu[0], q0=d.gt_q[0], p0=d.gt_p[0], v0=d.gt_v[0], bg0=d.gt_bg_cam[0],
                    ba0=d.gt_ba_cam[0])
        ps.append(np.asarray(run(st, JBank.create(cfg.tpu.max_features, eng.layout.max_clones), d)[2].p))
    out["replay_p"] = np.stack(ps)
    err = out["replay_p"] - np.asarray(sim.gt_p)[None, 1:]
    out["replay_rmse"] = np.sqrt(np.mean(np.sum(err ** 2, axis=-1)))

    cfg, sim, imgs = make_cfg_sim_frames()
    out.update({f"fused_sim_{k}": np.asarray(v) for k, v in sim._asdict().items() if v is not None})
    R_ItoC = np.asarray(quat_2_rot(jnp.asarray(cfg.cam_extrinsics[0:4])))
    out["fused_base_frames"] = np.stack([
        render_frame(np.asarray(sim.feat_p), np.asarray(quat_2_rot(sim.gt_q[i])), np.asarray(sim.gt_p[i]), R_ItoC,
                     np.asarray(cfg.cam_extrinsics[4:7]), np.asarray(cfg.cam_intrinsics), cfg.cam_wh)
        for i in range(1, N_FRAMES + 1)])
    eng = JEngine.from_config(cfg)
    state = j_init(eng, cfg, t0=sim.cam_t_imu[0], q0=sim.gt_q[0], p0=sim.gt_p[0], v0=sim.gt_v[0],
                   bg0=sim.gt_bg_cam[0], ba0=sim.gt_ba_cam[0])
    drv = JDriver(cfg, eng, batch=B_GLOBAL)
    tile = lambda x: jax.tree.map(lambda v: jnp.stack([v] * B_GLOBAL), x)  # noqa: E731
    states, banks, fevs = tile(state), tile(JBank.create(cfg.tpu.max_features, eng.layout.max_clones)), \
        tile(drv.init_frontend())
    rec = dict(p=[], q=[], pull=[])
    for i in range(1, N_FRAMES + 1):
        it, iw, ia = imu_window(cfg, sim, i)
        states, banks, fevs, o = drv.step_batch(states, banks, fevs, imgs[i - 1], np.tile(it, (B_GLOBAL, 1)),
                                                np.tile(iw, (B_GLOBAL, 1, 1)), np.tile(ia, (B_GLOBAL, 1, 1)),
                                                np.full(B_GLOBAL, float(sim.cam_t_imu[i])))
        rec["p"].append(np.asarray(o.p))
        rec["q"].append(np.asarray(o.q))
        rec["pull"].append(np.asarray(drv._pending_pull))
    drv.flush_stream()
    out.update(fused_p=np.stack(rec["p"], 1), fused_q=np.stack(rec["q"], 1), fused_pull=np.stack(rec["pull"]),
               fused_counters=np.asarray(drv.last_counters))
    # The committed base frames and the helper's noise give its images bit for bit.
    noise = np.random.default_rng(3).normal(0.0, 0.01, (B_GLOBAL, cfg.cam_wh[1], cfg.cam_wh[0])).astype(np.float32)
    for i in range(N_FRAMES):
        np.testing.assert_array_equal(np.clip(out["fused_base_frames"][i][None] + noise, 0.0, 1.0), imgs[i])
    return out


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "worker":
        case, rank, world, port, out_dir = sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), int(sys.argv[5]), sys.argv[6]
        torch.set_num_threads(1)
        from ov_plane_tpu_torch.parallel import distributed

        distributed.init_process("gloo", f"tcp://127.0.0.1:{port}", world, rank, timeout_s=240)
        try:
            WORKERS[case](rank, world, Path(out_dir))
        finally:
            torch.distributed.destroy_process_group()
    else:
        t = time.time()
        np.savez_compressed(REFERENCE, **generate())
        print(f"wrote {REFERENCE} ({REFERENCE.stat().st_size} bytes) in {time.time() - t:.1f} s")
