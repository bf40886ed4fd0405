"""The Monte-Carlo entry points of the port against the JAX package.

* ``run_sweep``: the port's ``run_sequence`` on JAX's own noisy instances
  (``jax.random`` draws of ``scripts/run_sweep.run_variant``, carried across
  by ``convert.sim_from_arrays``), 2 seeds × 20 frames of M-PT and M-PL,
  against the JAX outputs at the tolerance of ``tests/test_torch_planes.py``
  (every counter equal per frame; p and v 1e-6 m, q 1e-7, the covariance
  diagonal 1e-6 relative). A JAX run of the ladder costs minutes on the CPU,
  so the JAX outputs are committed (``tests/data/torch_sweep_jax.npz``), as
  is the statistics reference the card's sweep is held to
  (``ov_plane_tpu_torch/data/sweep_jax_reference.npz``: per-seed RMSE and
  NEES of all four variants over the 20 seeds of ``run_variant``, over the
  whole scan and over its first ``PREFIX_FRAMES``). Running
  this file as a script regenerates both:

      env JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_sweep.py

* ``ov_eval``: the tables of the port's and the JAX script on the same TUM
  files within 1e-9 (the printed tables equal);
* ``run_monte_carlo``: its metrics against the JAX formulas on the same outputs (1e-12);
* ``make_synth_asl``: a scene from the port's ``build_sim`` written as PNGs,
  equal to the JAX writer's frames of the same scene;
* ``run_real_suite --dry-run`` end to end at a few frames.
"""

import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
EXACT = ROOT / "tests" / "data" / "torch_sweep_jax.npz"
STATS = ROOT / "ov_plane_tpu_torch" / "data" / "sweep_jax_reference.npz"
DURATION = 6.0        # seconds of room scan: the shortest of 6-10 s at which JAX puts a CP plane into the state
SEEDS = 20
EXACT_SEEDS, EXACT_FRAMES = 2, 20
EXACT_VARIANTS = ("M-PT", "M-PL")
# First frames whose per-seed statistics the card's cut sweep is held to (chip_smoke.SWEEP_FRAMES).
PREFIX_FRAMES = (24,)
COUNTERS = ("n_msckf_used", "n_bank", "n_clones", "n_slam", "n_planes", "n_slam_init", "n_plane_init",
            "n_plane_constraints", "n_plane_merges", "n_plane_dropped")
METRICS = ("rmse_pos", "rmse_ori_deg", "nees_pos", "nees_ori")


def jax_sim(duration=DURATION, use_planes=True, seeds=SEEDS):
    """The JAX scene of a ladder variant and its ``run_variant`` noise draws
    (keys ``jax.random.split(PRNGKey(5), seeds)``, vmapped ``apply_noise``)."""
    import jax

    from ov_plane_tpu.sim.simulator import NoiseParams, apply_noise, build_sim
    from ov_plane_tpu_torch.scripts.run_sweep import make_config

    jcfg = _jax_config(make_config(duration, "", 0, use_planes))
    sim = build_sim(jcfg, max_obs=jcfg.tpu.max_obs_per_frame)
    noise = NoiseParams(sigma_w=jcfg.imu_noises.sigma_w, sigma_a=jcfg.imu_noises.sigma_a,
                        sigma_wb=jcfg.imu_noises.sigma_wb, sigma_ab=jcfg.imu_noises.sigma_ab,
                        sigma_pix=jcfg.msckf_options.sigma_pix, dt_imu=1.0 / jcfg.sim.freq_imu)
    keys = jax.random.split(jax.random.PRNGKey(5), seeds)
    return jax.vmap(lambda k: apply_noise(sim, k, noise))(keys)


def _jax_config(cfg):
    """The JAX VioConfig with the port configuration's values."""
    from ov_plane_tpu.utils.config import sim_config as j_sim_config

    jcfg = j_sim_config()
    for sec in ("state", "tpu", "sim", "msckf_options", "slam_options", "imu_noises", "featinit", "trackplane"):
        for k, v in vars(getattr(cfg, sec)).items():
            setattr(getattr(jcfg, sec), k, v)
    for k in ("num_pts", "num_pts_plane", "cam_wh", "cam_intrinsics", "cam_extrinsics", "cam_model",
              "gravity_mag", "calib_camimu_dt"):
        setattr(jcfg, k, getattr(cfg, k))
    return jcfg


def jax_run(name, sims, n_frames=None):
    """The JAX ladder variant ``name`` over the vmapped noise draws ``sims``
    (``run_variant``'s ``one_seed``, float64 on the CPU); returns its
    per-seed outputs as numpy arrays [S, F, ...]."""
    import jax

    from ov_plane_tpu.models.feature_bank import FeatureBank
    from ov_plane_tpu.models.manager import VioEngine, init_state_with_gt, run_sequence
    from ov_plane_tpu_torch.scripts.run_sweep import VARIANTS, make_config

    max_slam, use_planes = VARIANTS[name]
    jcfg = _jax_config(make_config(DURATION, "", max_slam, use_planes))
    eng = VioEngine.from_config(jcfg)
    if n_frames is not None:
        cam = ("cam_t", "cam_t_imu", "obs_id", "obs_uv", "obs_uv_true", "obs_plane", "obs_gt_p", "obs_gt_cp",
               "imu_window_start", "gt_q", "gt_p", "gt_v", "gt_bg_cam", "gt_ba_cam")
        sims = sims._replace(**{k: getattr(sims, k)[:, :n_frames + 1] for k in cam})

    def one_seed(s):
        state = init_state_with_gt(eng, jcfg, t0=s.cam_t_imu[0], q0=s.gt_q[0], p0=s.gt_p[0], v0=s.gt_v[0],
                                   bg0=s.gt_bg_cam[0], ba0=s.gt_ba_cam[0])
        bank = FeatureBank.create(jcfg.tpu.max_features, eng.layout.max_clones)
        return run_sequence(eng, state, bank, s, imu_window=jcfg.tpu.max_imu_per_frame)[2]

    outs = jax.jit(jax.vmap(one_seed))(sims)
    return {k: np.asarray(v) for k, v in outs._asdict().items() if v is not None}


def metrics(outs: dict, gt_q, gt_p) -> dict:
    """Per-seed RMSE and NEES of run outputs (``eval/metrics.rmse_nees`` of the port, float64 on the CPU)."""
    from ov_plane_tpu_torch.eval.metrics import rmse_nees

    t = {k: torch.as_tensor(outs[k], dtype=torch.float64) for k in ("q", "p", "cov_diag_imu")}
    m = rmse_nees(t["q"], t["p"], t["cov_diag_imu"][..., 0:3], t["cov_diag_imu"][..., 3:6],
                  torch.as_tensor(gt_q, dtype=torch.float64), torch.as_tensor(gt_p, dtype=torch.float64))
    return {k: m[k].numpy() for k in METRICS}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", EXACT_VARIANTS)
def test_sweep_matches_jax_on_its_noise(name):
    from ov_plane_tpu_torch import convert
    from ov_plane_tpu_torch.scripts.run_sweep import VARIANTS, make_config, run_variant

    max_slam, use_planes = VARIANTS[name]
    draws = jax_sim(use_planes=use_planes)
    arrays = {k: np.asarray(v)[:EXACT_SEEDS] for k, v in draws._asdict().items()}
    sim = convert.sim_from_arrays(arrays, device="cpu")
    assert sim.imu_w.shape[0] == EXACT_SEEDS
    run = run_variant(make_config(DURATION, "", max_slam, use_planes), EXACT_SEEDS, "cpu", sim=sim,
                      n_frames=EXACT_FRAMES)
    with np.load(EXACT) as ref:
        for k in COUNTERS:
            np.testing.assert_array_equal(getattr(run.outs, k).numpy(), ref[f"{name}/{k}"], err_msg=k)
        np.testing.assert_allclose(run.p, ref[f"{name}/p"], rtol=0, atol=1e-6)
        np.testing.assert_allclose(run.outs.v.numpy(), ref[f"{name}/v"], rtol=0, atol=1e-6)
        np.testing.assert_allclose(run.q, ref[f"{name}/q"], rtol=0, atol=1e-7)
        np.testing.assert_allclose(run.outs.cov_diag_imu.numpy(), ref[f"{name}/cov_diag_imu"], rtol=1e-6, atol=0)
        assert (ref[f"{name}/n_msckf_used"].sum() > 100
                and (ref[f"{name}/n_planes"].max() > 0) == use_planes)
    np.testing.assert_array_equal(run.gt_p, np.asarray(draws.gt_p[0, 1:EXACT_FRAMES + 1]))


def test_sweep_reference_holds_the_ladder():
    """The committed statistics reference: every variant over 20 seeds, CP
    planes on the plane variants and SLAM landmarks on the SLAM variants."""
    from ov_plane_tpu_torch.scripts.run_sweep import VARIANTS

    with np.load(STATS) as z:
        assert float(z["duration"]) == DURATION and int(z["seeds"]) == SEEDS
        for name, (max_slam, use_planes) in VARIANTS.items():
            for k in METRICS:
                assert z[f"{name}/{k}"].shape == (SEEDS,) and np.isfinite(z[f"{name}/{k}"]).all()
            assert (int(z[f"{name}/streams_with_planes"]) == SEEDS) == use_planes
            assert (int(z[f"{name}/first_slam_frame"]) > 0) == (max_slam > 0)


def _write_runs(root: Path, rng):
    """Two algorithms' TUM estimates of one sequence against its truth."""
    from ov_plane_tpu_torch.eval.io import write_tum
    from ov_plane_tpu_torch.ops.quat import exp_so3, quat_multiply, rot_2_quat

    t = 0.1 * np.arange(300)
    gt_p = np.stack([8 * np.sin(0.2 * t), 6 * np.cos(0.13 * t), 0.3 * np.sin(t)], axis=1)
    gt_q = rot_2_quat(exp_so3(torch.as_tensor(np.stack([0.05 * np.sin(t), 0.04 * t, 0.3 * t], axis=1)))).numpy()
    write_tum(str(root / "truths" / "seq_a.txt"), t, gt_p, gt_q)
    for algo in ("A", "B"):
        for k in range(3):
            dq = rot_2_quat(exp_so3(torch.as_tensor(0.01 * rng.normal(size=(300, 3))))).numpy()
            q = quat_multiply(torch.as_tensor(dq), torch.as_tensor(gt_q)).numpy()
            write_tum(str(root / "algorithms" / algo / "seq_a" / f"estimate_{k}.txt"), t[1:-5] + 0.003,
                      gt_p[1:-5] + 0.05 * rng.normal(size=(294, 3)), q[1:-5])


def _jax_ov_eval():
    import importlib.util

    spec = importlib.util.spec_from_file_location("jax_ov_eval", ROOT / "scripts" / "ov_eval.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_ov_eval_matches_jax(tmp_path, capsys):
    import argparse

    from ov_plane_tpu_torch.scripts import ov_eval

    _write_runs(tmp_path, np.random.default_rng(0))
    jmod = _jax_ov_eval()
    gt = str(tmp_path / "truths" / "seq_a.txt")
    for k in range(3):
        est = str(tmp_path / "algorithms" / "B" / "seq_a" / f"estimate_{k}.txt")
        a, b = ov_eval.eval_one(gt, est, device="cpu"), jmod.eval_one(gt, est)
        assert a["n"] == b["n"] == 294 and set(a["rpe"]) == set(b["rpe"]) and a["rpe"]
        for key in ("length", "ate_pos", "ate_ori_deg"):
            np.testing.assert_allclose(a[key], b[key], rtol=0, atol=1e-9)
        for L in a["rpe"]:
            np.testing.assert_allclose(a["rpe"][L], b["rpe"][L], rtol=0, atol=1e-9)
    paths = [str(tmp_path / "truths"), str(tmp_path / "algorithms" / "A"), str(tmp_path / "algorithms" / "B")]
    ov_eval.main(["error_comparison", *paths, "--device", "cpu"])
    port_table = capsys.readouterr().out
    jmod.cmd_error_comparison(argparse.Namespace(paths=paths))
    assert port_table == capsys.readouterr().out
    timing = tmp_path / "timing.csv"
    np.savetxt(timing, np.random.default_rng(1).uniform(size=(50, 4)), delimiter=",", header="t,a,b,total")
    ov_eval.main(["timing_comparison", str(timing), "--device", "cpu"])
    port_table = capsys.readouterr().out
    jmod.cmd_timing_comparison(argparse.Namespace(paths=[str(timing)]))
    assert port_table == capsys.readouterr().out


def test_monte_carlo_metrics_match_jax():
    import jax.numpy as jnp

    from ov_plane_tpu.eval.metrics import nees_full, ori_pos_errors, rmse_nees
    from ov_plane_tpu_torch.models.manager import StepOutput
    from ov_plane_tpu_torch.ops.quat import exp_so3, quat_multiply, rot_2_quat
    from ov_plane_tpu_torch.scripts.run_monte_carlo import mc_metrics, report, verdicts

    rng = np.random.default_rng(4)
    S, F = 3, 40
    gt_q = rot_2_quat(exp_so3(torch.as_tensor(rng.normal(size=(F, 3))))).numpy()
    gt_p = rng.normal(size=(F, 3))
    dq = rot_2_quat(exp_so3(torch.as_tensor(0.01 * rng.normal(size=(S, F, 3)))))
    q = quat_multiply(dq, torch.as_tensor(gt_q).expand(S, F, 4)).numpy()
    p = gt_p + 0.05 * rng.normal(size=(S, F, 3))
    cov = rng.uniform(1e-4, 1e-2, size=(S, F, 15))
    A = rng.normal(size=(S, F, 2, 3, 3))
    blk = A @ np.swapaxes(A, -1, -2) * 1e-3 + 1e-4 * np.eye(3)
    fields = {f: torch.zeros(S, F) for f in StepOutput._fields}
    outs = StepOutput(**{**fields, "q": torch.as_tensor(q), "p": torch.as_tensor(p),
                         "cov_diag_imu": torch.as_tensor(cov), "cov_ori_blk": torch.as_tensor(blk[:, :, 0]),
                         "cov_pos_blk": torch.as_tensor(blk[:, :, 1])})
    m = mc_metrics(outs, gt_q, gt_p)
    for s in range(S):
        ref = rmse_nees(jnp.asarray(q[s]), jnp.asarray(p[s]), jnp.asarray(cov[s, :, 0:3]), jnp.asarray(cov[s, :, 3:6]),
                        jnp.asarray(gt_q), jnp.asarray(gt_p))
        for k in ("rmse_ori_deg", "rmse_pos", "nees_ori", "nees_pos"):
            np.testing.assert_allclose(m[k][s], float(ref[k]), rtol=1e-12, atol=0)
        e_th, e_p = ori_pos_errors(jnp.asarray(q[s]), jnp.asarray(p[s]), jnp.asarray(gt_q), jnp.asarray(gt_p))
        np.testing.assert_allclose(m["nees_ori_t"][s], np.sum(np.asarray(e_th) ** 2 / cov[s, :, 0:3], axis=1),
                                   rtol=1e-12)
        np.testing.assert_allclose(m["nees_pos_t"][s], np.sum(np.asarray(e_p) ** 2 / cov[s, :, 3:6], axis=1),
                                   rtol=1e-12)
        np.testing.assert_allclose(m["neesf_ori_t"][s], np.asarray(nees_full(e_th, jnp.asarray(blk[s, :, 0]))),
                                   rtol=1e-12)
        np.testing.assert_allclose(m["neesf_pos_t"][s], np.asarray(nees_full(e_p, jnp.asarray(blk[s, :, 1]))),
                                   rtol=1e-12)
    # The JAX script's bands (examples/run_monte_carlo.py:90-94).
    t = np.arange(F) * 0.1
    nees_ok = 0.05 < m["nees_ori"].mean() < 9.0 and 0.05 < m["nees_pos"].mean() < 9.0
    assert verdicts(m, float(t[-1] - t[0])) == (nees_ok, m["rmse_pos"].mean() < 0.2 + 2e-4 * 3.9)
    text = report(m, t, trend=4)
    assert text.count("    t=[") == 4 and text.splitlines()[-1].startswith("NEES ")


def test_make_synth_asl_matches_jax_writer_frames(tmp_path):
    """The port's writer on a 3 s room scan built by its ``build_sim`` (held
    to the JAX ``build_sim`` by tests/test_torch_sim.py): the PNG frames
    equal the JAX writer's ``(render(...) * 255).astype(uint8)`` of the same
    scene, blobs alone (3 frames) and the textured room under them (1 frame)."""
    from ov_plane_tpu.frontend.synthetic import render_frame as j_render_frame
    from ov_plane_tpu.frontend.synthetic import render_frame_textured as j_render_textured
    from ov_plane_tpu.ops.quat import quat_2_rot as j_quat_2_rot
    from ov_plane_tpu_torch.eval import png
    from ov_plane_tpu_torch.scripts import make_synth_asl
    from ov_plane_tpu_torch.sim.simulator import build_sim

    cfg = make_synth_asl.synth_config(duration=3.0, num_pts=30, num_pts_plane=20)
    truth = build_sim(cfg, device="cpu")
    scene = {k: getattr(truth, k).numpy() for k in ("feat_p", "gt_q", "gt_p", "cam_t_imu", "plane_corners",
                                                     "plane_normal", "plane_d")}
    zeta, wh = np.asarray(cfg.cam_intrinsics), cfg.cam_wh
    for textured, frames in ((False, 3), (True, 1)):
        out = tmp_path / f"textured_{textured}"
        info = make_synth_asl.write_sim_asl(str(out), cfg, textured=textured, frames=frames, device="cpu")
        assert info["frames"] == frames
        rows = (out / "mav0" / "cam0" / "data.csv").read_text().splitlines()[1:]
        names = [line.split(",")[1].strip() for line in rows]
        assert names == [f"{int(t * 1e9)}.png" for t in scene["cam_t_imu"][:frames]]
        for k, name in enumerate(names):
            R, p = np.array(j_quat_2_rot(scene["gt_q"][k])), scene["gt_p"][k]
            if textured:
                img = j_render_textured(scene["plane_corners"], scene["plane_normal"], scene["plane_d"],
                                        scene["feat_p"], R, p, np.eye(3), np.zeros(3), zeta, wh)
            else:
                img = j_render_frame(scene["feat_p"], R, p, np.eye(3), np.zeros(3), zeta, wh)
            assert (img > 0.12).sum() > 1000
            np.testing.assert_array_equal(png.read_gray(out / "mav0" / "cam0" / "data" / name),
                                          (img * 255).astype(np.uint8))
    gt = np.loadtxt(out / "mav0" / "state_groundtruth_estimate0" / "data.csv", delimiter=",", comments="#", ndmin=2)
    np.testing.assert_allclose(gt[:, 1:4], scene["gt_p"][:frames], rtol=0, atol=1e-9)


def test_run_real_suite_dry_run(tmp_path, capsys, monkeypatch):
    """The real-data protocol end to end on its stand-ins: two sequences,
    each the first 14 frames of the stand-in that ``--dry-run`` would
    synthesize (written here ahead, so the suite keeps them), the M-PL
    replays of 12 frames each in processes of their own, the ATE table and
    the timing statistics."""
    import json

    from ov_plane_tpu_torch.scripts import make_synth_asl, run_real_suite

    # The replays' processes take one thread each, as the test processes do.
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = tmp_path / "suite"
    for name, dur, npl in run_real_suite.DRY_RUN_SEQUENCES:
        cfg = make_synth_asl.synth_config(duration=dur, num_pts=60, num_pts_plane=npl)
        make_synth_asl.write_sim_asl(str(out / "synth_data" / name), cfg, frames=14, device="cpu")
    assert run_real_suite.main(["--dry-run", "--out", str(out), "--device", "cpu", "--variants", "M-PL",
                                "--max-frames", "12"]) == 0
    manifest = json.loads((out / "manifest.json").read_text())
    assert [(m["variant"], m["seq"], m["ok"]) for m in manifest] == [
        ("M-PL", "synth_table_01", True), ("M-PL", "synth_table_02", True)]
    for seq in ("synth_table_01", "synth_table_02"):
        assert len(np.loadtxt(out / "algorithms" / "M-PL" / seq / "00_estimate.txt")) == 12
        assert (out / "truths" / f"{seq}.txt").exists()
    table = (out / "ate_comparison.txt").read_text().splitlines()
    assert table[0].split() == ["algorithm", "synth_table_01", "synth_table_02"]
    cells = table[1].split()
    assert cells[0] == "M-PL" and all("/" in c and "±" in c for c in cells[1:])
    assert float(cells[1].split("/")[1].split("±")[0]) < 0.5
    assert "LaTeX" in (out / "timing_comparison.txt").read_text()
    assert "2/2 runs ok" in capsys.readouterr().out


def generate():
    """Both committed references from JAX runs on the CPU (float64)."""
    from ov_plane_tpu_torch.scripts.run_sweep import VARIANTS

    exact, stats = {}, {"duration": np.float64(DURATION), "seeds": np.int64(SEEDS)}
    for use_planes in (False, True):
        sims = jax_sim(use_planes=use_planes)
        gt_q, gt_p = np.asarray(sims.gt_q[0, 1:]), np.asarray(sims.gt_p[0, 1:])
        for name, (_, planes) in VARIANTS.items():
            if planes != use_planes:
                continue
            t = time.time()
            outs = jax_run(name, sims)
            m = metrics(outs, gt_q, gt_p)
            for n in PREFIX_FRAMES:
                stats.update({f"{name}/f{n}/{k}": v for k, v in
                              metrics({k: v[:, :n] for k, v in outs.items()}, gt_q[:n], gt_p[:n]).items()})
            first = np.nonzero(outs["n_planes"].max(axis=0) > 0)[0]
            first_slam = np.nonzero(outs["n_slam"].max(axis=0) > 0)[0]
            stats.update({f"{name}/{k}": v for k, v in m.items()})
            stats[f"{name}/first_plane_frame"] = np.int64(first[0] + 1 if first.size else -1)
            stats[f"{name}/first_slam_frame"] = np.int64(first_slam[0] + 1 if first_slam.size else -1)
            stats[f"{name}/streams_with_planes"] = np.int64((outs["n_planes"].max(axis=1) > 0).sum())
            print(f"[{name}] {SEEDS} seeds x {outs['p'].shape[1]} frames in {time.time() - t:.1f} s: "
                  + " ".join(f"{k} {v.mean():.4f}±{v.std(ddof=1) / np.sqrt(SEEDS):.4f}" for k, v in m.items())
                  + f"; first plane state at frame {stats[f'{name}/first_plane_frame']} "
                  f"({stats[f'{name}/streams_with_planes']} streams), first SLAM landmark at frame "
                  f"{stats[f'{name}/first_slam_frame']}", file=sys.stderr)
            if name in EXACT_VARIANTS:
                exact.update({f"{name}/{k}": v[:EXACT_SEEDS, :EXACT_FRAMES] for k, v in outs.items()})
    np.savez_compressed(STATS, **stats)
    np.savez_compressed(EXACT, **exact)


if __name__ == "__main__":
    import jax

    jax.config.update("jax_enable_x64", True)
    generate()
