"""The port's parallel layer against the JAX package's ``tests/test_parallel.py``
and ``tests/test_map_blocks.py``: the batched replay, the information form on
zero rows, the sharded classic update (``tpu.shard_axis``) and ``sharded_knn``.

The sharded runs use two processes on the CPU joined by gloo (this file run
as ``python tests/test_torch_parallel.py worker ...``), each with a time
limit; a mesh ('dp' = 1, 'sp' = 2) shares the rows of each classic update.
The JAX replays need the JAX ``build_sim`` (about 16 s a scene) and a
compile each, so the JAX sides of the replays are committed with their
inputs in ``tests/data/torch_parallel_jax.npz``; regenerate it with

    env JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_parallel.py

(about two minutes). ``sharded_knn`` and the zero-row case run JAX here.
"""

import dataclasses
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from ov_plane_tpu_torch import convert
from ov_plane_tpu_torch.models.feature_bank import FeatureBank
from ov_plane_tpu_torch.models.manager import VioEngine, init_state_with_gt, run_sequence
from ov_plane_tpu_torch.utils import config as tconfig

ROOT = Path(__file__).resolve().parents[1]
REFERENCE = ROOT / "tests" / "data" / "torch_parallel_jax.npz"
WORLD = 2
WORKER_TIMEOUT = 240      # seconds for a pair of workers, start-up included
SCENES = ("point", "plane")     # test_parallel.py:110 and :158
KNN_PER_RANK, KNN_K = 32, 5
PLANE_COUNTERS = ("n_plane_init", "n_plane_constraints", "n_planes")


def configure(cfg, scene: str):
    """test_parallel.py's settings of the point (:110) or plane (:158) replay,
    applied alike to a JAX and a port configuration."""
    planes = scene == "plane"
    cfg.sim.traj_duration = 6.0 if planes else 5.0
    cfg.state.max_slam_features = 0
    cfg.state.use_plane_constraint = planes
    cfg.state.use_plane_slam_feats = planes
    cfg.state.do_calib_camera_pose = False
    cfg.state.do_calib_camera_intrinsics = False
    cfg.state.do_calib_camera_timeoffset = False
    cfg.num_pts = 12 if planes else 20
    cfg.num_pts_plane = 30 if planes else 0
    cfg.tpu.max_features = 96 if planes else 64
    cfg.tpu.max_obs_per_frame = 64 if planes else 48
    cfg.tpu.max_msckf_update = 32 if planes else 24
    cfg.tpu.use_info_compression = True
    return cfg


def scene_arrays(ref, scene: str) -> dict:
    pre = f"{scene}_sim_"
    return {k[len(pre):]: ref[k] for k in ref if k.startswith(pre)}


def port_run(scene: str, arrays: dict, shard_axis: str = "", batch: int = 1):
    """The port's replay of the scene's JAX draw (``batch`` copies) on the CPU in f64."""
    cfg = configure(tconfig.sim_config(), scene)
    cfg.tpu.shard_axis = shard_axis
    eng = VioEngine.from_config(cfg, device="cpu")
    sim = convert.sim_from_arrays(arrays, device="cpu")
    sim = sim._replace(**{k: getattr(sim, k).expand(batch, *getattr(sim, k).shape[1:]) for k in convert.NOISY_FIELDS})
    state = init_state_with_gt(eng, cfg, t0=sim.cam_t_imu[0].expand(batch), q0=sim.gt_q[0].expand(batch, 4),
                               p0=sim.gt_p[0].expand(batch, 3), v0=sim.gt_v[0].expand(batch, 3),
                               bg0=sim.gt_bg_cam[:, 0], ba0=sim.gt_ba_cam[:, 0], device="cpu")
    bank = FeatureBank.create(cfg.tpu.max_features, eng.layout.max_clones, batch, device="cpu")
    return eng, cfg, sim, state, bank


# ----------------------------------------------------------------------
# Worker processes.

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Workers:
    """``python script worker case rank world port dir`` for every rank,
    started at once; :meth:`result` waits at most ``timeout`` seconds from
    the start for all of them (a worker still running then is killed and the
    test fails) and returns each rank's npz."""

    def __init__(self, script: Path, case: str, tmp_path: Path, world: int = WORLD, timeout: float = WORKER_TIMEOUT):
        self.case, self.tmp_path, self.world, self.timeout = case, tmp_path, world, timeout
        env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
        port = free_port()
        self.deadline = time.time() + timeout
        self.procs = [subprocess.Popen([sys.executable, str(script), "worker", case, str(r), str(world), str(port),
                                        str(tmp_path)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True) for r in range(world)]
        self._out = None

    def result(self):
        if self._out is not None:
            return self._out
        logs = []
        try:
            for p in self.procs:
                logs.append(p.communicate(timeout=max(1.0, self.deadline - time.time()))[0])
        except subprocess.TimeoutExpired:
            for p in self.procs:
                p.kill()
            logs = [p.communicate()[0] for p in self.procs]
            pytest.fail(f"{self.case}: the workers did not finish in {self.timeout} s\n" + "\n".join(logs))
        if any(p.returncode != 0 for p in self.procs):
            pytest.fail(f"{self.case}: a worker failed\n" + "\n".join(logs))
        self._out = []
        for r in range(self.world):
            with np.load(self.tmp_path / f"{self.case}_{r}.npz") as z:
                self._out.append({k: z[k] for k in z.files})
        return self._out

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


def worker_sharded(rank: int, world: int, out: Path):
    """Both replays with the classic update's rows over 'sp', and sharded_knn."""
    from ov_plane_tpu_torch.frontend.map_blocks import sharded_knn
    from ov_plane_tpu_torch.parallel import distributed

    mesh = distributed.global_mesh(("dp", "sp"), shape=(1, world))
    with np.load(REFERENCE) as z:
        ref = {k: z[k] for k in z.files}
    res = {}
    for scene in SCENES:
        eng, cfg, sim, state, bank = port_run(scene, scene_arrays(ref, scene), shard_axis="sp")
        state, bank, outs = run_sequence(eng, state, bank, sim, imu_window=cfg.tpu.max_imu_per_frame)
        res.update({f"{scene}_{k}": v.numpy() for k, v in outs._asdict().items()})
        res.update({f"{scene}_state_{k}": v.numpy() for k, v in state.tensors().items()})
    pts = torch.from_numpy(ref["knn_points"])
    active = torch.from_numpy(ref["knn_active"])
    sl = distributed.axis_slab(mesh, "sp", pts.shape[0])
    d, idx = sharded_knn(pts[sl], active[sl], torch.from_numpy(ref["knn_queries"]), KNN_K, mesh.get_group("sp"))
    res.update(knn_d=d.numpy(), knn_idx=idx.numpy())
    np.savez(out / f"sharded_{rank}.npz", **res)


WORKERS = {"sharded": worker_sharded}


# ----------------------------------------------------------------------
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
def sharded(tmp_path_factory):
    """The two workers, started before the single-process runs they are held to."""
    job = Workers(Path(__file__), "sharded", tmp_path_factory.mktemp("sharded"))
    yield job
    job.kill()


@pytest.fixture(scope="module")
def unsharded(reference):
    """The port's single-process runs with the unsharded information form."""
    out = {}
    for scene in SCENES:
        eng, cfg, sim, state, bank = port_run(scene, scene_arrays(reference, scene))
        out[scene] = run_sequence(eng, state, bank, sim, imu_window=cfg.tpu.max_imu_per_frame)[2]
    return out


def test_batched_replay_matches_jax(reference):
    """test_parallel.py:67: ``batched_replay`` of 4 streams of one draw (JAX
    over a 4-device mesh, the port with no mesh): every stream's trajectory
    and the fleet RMSE against JAX's."""
    from ov_plane_tpu_torch.parallel.replay import batched_replay, replicate

    eng, cfg, sim, state, bank = port_run("point", scene_arrays(reference, "point"), batch=4)
    outs, rmse = batched_replay(eng, state, bank, replicate(sim, None), cfg.tpu.max_imu_per_frame, None)
    p = outs.p.numpy()
    np.testing.assert_allclose(p, reference["replay_p"], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(outs.n_msckf_used.numpy(), reference["replay_n_msckf_used"])
    np.testing.assert_allclose(float(rmse), float(reference["replay_rmse"]), rtol=1e-6)
    err = p - sim.gt_p[1:p.shape[1] + 1].numpy()
    assert float(rmse) == pytest.approx(float(np.sqrt(np.mean(np.sum(err ** 2, axis=-1)))), rel=1e-12)
    assert float(rmse) < 1.0 and (p[0] == p[-1]).all()


def test_information_to_compressed_on_zero_rows():
    """test_parallel.py:56: an all-masked block gives finite (R, y) with
    Rᵀy = 0, as the JAX function gives them."""
    import jax.numpy as jnp

    from ov_plane_tpu.parallel import schur as j_schur
    from ov_plane_tpu_torch.parallel import schur

    D = 8
    lam, eta = schur.local_information(torch.zeros(1, 4, D, dtype=torch.float64), torch.zeros(1, 4, dtype=torch.float64))
    R, y = schur.information_to_compressed(lam, eta)
    assert torch.isfinite(R).all() and torch.isfinite(y).all()
    np.testing.assert_allclose((R[0].T @ y[0]).numpy(), np.zeros(D), atol=1e-12)
    jR, jy = j_schur.information_to_compressed(*j_schur.local_information(jnp.zeros((4, D)), jnp.zeros(4)))
    np.testing.assert_allclose(R[0].numpy(), np.asarray(jR), rtol=0, atol=1e-15)
    np.testing.assert_array_equal(y[0].numpy(), np.asarray(jy))


@pytest.mark.parametrize("scene", SCENES)
def test_sharded_update_matches_unsharded(scene, sharded, unsharded, reference):
    """test_parallel.py:110 (point) and :158 (plane): the replay with the
    classic update's rows split over two gloo processes ('sp') matches the
    unsharded information form within 1e-8 m, with every counter equal; both
    ranks hold bitwise the same state (the all_reduce hands them the same
    Λ); and the port's unsharded run agrees with JAX's unsharded run."""
    ref = unsharded[scene]
    sharded = sharded.result()
    for r in sharded:
        p = r[f"{scene}_p"]
        assert np.isfinite(p).all()
        np.testing.assert_allclose(p, ref.p.numpy(), rtol=0, atol=1e-8)
        for name in ("n_msckf_used",) + (PLANE_COUNTERS if scene == "plane" else ()):
            np.testing.assert_array_equal(r[f"{scene}_{name}"], getattr(ref, name).numpy(), err_msg=name)
    keys = [k for k in sharded[0] if k.startswith(f"{scene}_")]
    for k in keys:
        np.testing.assert_array_equal(sharded[1][k], sharded[0][k], err_msg=f"ranks differ in {k}")
    np.testing.assert_allclose(ref.p[0].numpy(), reference[f"{scene}_p"], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(ref.n_msckf_used[0].numpy(), reference[f"{scene}_n_msckf_used"])
    if scene == "plane":
        for name in PLANE_COUNTERS:
            np.testing.assert_array_equal(getattr(ref, name)[0].numpy(), reference[f"plane_{name}"], err_msg=name)
        # The plane machinery fired (the JAX test's own check).
        assert ref.n_plane_init.sum() >= 1 and ref.n_plane_constraints.sum() > 0 and ref.n_planes.max() >= 1
    assert ref.n_msckf_used.sum() > 20


def test_sharded_knn_matches_knn(sharded, reference):
    """test_map_blocks.py:59: the 2-shard KNN equals the one-device ``knn``
    (distances and indices, ties to the lower index) and JAX's 8-shard
    ``sharded_knn`` within 1e-9; both ranks hold the same bits."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    from ov_plane_tpu.frontend import map_blocks as j_mb
    from ov_plane_tpu_torch.frontend.map_blocks import MapBlocks, knn

    sharded = sharded.result()
    pts, active, q = reference["knn_points"], reference["knn_active"], reference["knn_queries"]
    m = dataclasses.replace(MapBlocks.create(pts.shape[0], dtype=torch.float64, device="cpu"),
                            points=torch.from_numpy(pts),
                            plane_id=torch.where(torch.from_numpy(active), 0, -1).to(torch.int32))
    d1, i1 = knn(m, torch.from_numpy(q), KNN_K)
    mesh = Mesh(np.array(jax.devices()), axis_names=("shard",))
    f = shard_map(lambda p_, a_, q_: j_mb.sharded_knn(p_, a_, q_, KNN_K, "shard"), mesh=mesh,
                  in_specs=(P("shard", None), P("shard"), P()), out_specs=P(), check_rep=False)
    jd = np.asarray(jax.jit(f)(jnp.asarray(pts), jnp.asarray(active), jnp.asarray(q)))
    for r in sharded:
        np.testing.assert_array_equal(r["knn_d"], d1.numpy())
        np.testing.assert_array_equal(r["knn_idx"], i1.numpy())
        np.testing.assert_allclose(r["knn_d"], jd, rtol=0, atol=1e-9)
    np.testing.assert_array_equal(sharded[1]["knn_d"], sharded[0]["knn_d"])
    for i in range(len(q)):
        brute = np.sort(np.linalg.norm(pts[active] - q[i], axis=1))[:KNN_K]
        np.testing.assert_allclose(sharded[0]["knn_d"][i], brute, atol=1e-9)


# ----------------------------------------------------------------------
def generate() -> dict:
    """The JAX sides: both scenes' draws and unsharded replays (info form),
    the 4-stream ``batched_replay`` over a 4-device mesh, and the KNN points."""
    import jax

    from ov_plane_tpu.models.feature_bank import FeatureBank as JBank
    from ov_plane_tpu.models.manager import VioEngine as JEngine
    from ov_plane_tpu.models.manager import init_state_with_gt as j_init
    from ov_plane_tpu.models.manager import run_sequence as j_run
    from ov_plane_tpu.parallel.replay import batched_replay, make_mesh, replicate, shard_leading_axis
    from ov_plane_tpu.sim.simulator import build_sim
    from ov_plane_tpu.utils.config import sim_config

    jax.config.update("jax_enable_x64", True)
    out = {}
    for scene in SCENES:
        cfg = configure(sim_config(), scene)
        sim = build_sim(cfg, max_obs=cfg.tpu.max_obs_per_frame)
        out.update({f"{scene}_sim_{k}": np.asarray(v) for k, v in sim._asdict().items() if v is not None})
        eng = JEngine.from_config(cfg)
        st = j_init(eng, cfg, t0=sim.cam_t_imu[0], q0=sim.gt_q[0], p0=sim.gt_p[0], v0=sim.gt_v[0],
                    bg0=sim.gt_bg_cam[0], ba0=sim.gt_ba_cam[0])
        bk = JBank.create(cfg.tpu.max_features, eng.layout.max_clones)
        _, _, outs = j_run(eng, st, bk, sim, imu_window=cfg.tpu.max_imu_per_frame)
        out[f"{scene}_p"] = np.asarray(outs.p)
        for name in ("n_msckf_used",) + (PLANE_COUNTERS if scene == "plane" else ()):
            out[f"{scene}_{name}"] = np.asarray(getattr(outs, name))
        if scene == "point":
            states = jax.tree.map(lambda x: jax.numpy.stack([x] * 4), st)
            banks = jax.tree.map(lambda x: jax.numpy.stack([x] * 4), bk)
            mesh = make_mesh(4)
            r_outs, rmse = batched_replay(eng, shard_leading_axis(states, mesh), shard_leading_axis(banks, mesh),
                                          replicate(sim, mesh), cfg.tpu.max_imu_per_frame, mesh)
            out.update(replay_p=np.asarray(r_outs.p), replay_n_msckf_used=np.asarray(r_outs.n_msckf_used),
                       replay_rmse=np.asarray(rmse))
    rng = np.random.default_rng(13)
    n = 8 * KNN_PER_RANK
    out["knn_points"] = rng.normal(size=(n, 3)) * 2
    active = np.ones(n, bool)
    active[3] = False
    out["knn_active"] = active
    out["knn_queries"] = rng.normal(size=(6, 3))
    return out


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "worker":
        case, rank, world, port, out_dir = sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), int(sys.argv[5]), sys.argv[6]
        torch.set_num_threads(1)
        from ov_plane_tpu_torch.parallel import distributed

        distributed.init_process("gloo", f"tcp://127.0.0.1:{port}", world, rank, timeout_s=WORKER_TIMEOUT)
        try:
            WORKERS[case](rank, world, Path(out_dir))
        finally:
            torch.distributed.destroy_process_group()
    else:
        t = time.time()
        np.savez_compressed(REFERENCE, **generate())
        print(f"wrote {REFERENCE} ({REFERENCE.stat().st_size} bytes) in {time.time() - t:.1f} s")
