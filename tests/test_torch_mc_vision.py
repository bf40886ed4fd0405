"""Parity of the port's ``scripts/run_mc_vision`` with the JAX script.

``scene_config`` equals the JAX script's field by field for every scene and
density, and ``paired_stats`` its statistics. ``run_variant`` runs two
streams of JAX's own IMU noise draws (``apply_noise`` per key, carried by
``convert.sim_from_arrays``) over the first 6 frames of the tabletop scene
against the JAX function, with the same frames and the same image-noise
stream, on the f32 wire with the exact ``mm`` sampler (the JAX driver's
``OVP_IMG_WIRE`` / ``OVP_KLT_SAMPLER``, the port's driver arguments): track
ids and valid flags equal on every frame, the ATE within 1e-6 m and
ATE_DEG_TOL. Last, ``main`` runs end to end on the CPU and its JSON is read
back. Both runs are at the scripts' 640×480.
"""

import dataclasses
import functools
import importlib.util
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ov_plane_tpu_torch import convert
from ov_plane_tpu_torch.scripts import run_mc_vision as mc

ROOT = Path(__file__).resolve().parents[1]
SCENES = ("tabletop", "room", "corridor", "lowtex")
PARITY_FRAMES = 6
ATE_DEG_TOL = 1e-4     # deg; twice the 4.431e-5 deg read on the CPU


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jmc():
    """The JAX script as a module; the JAX settings its import changes
    (compilation cache directory, matmul precision) are restored."""
    keep = {k: getattr(jax.config, k) for k in ("jax_compilation_cache_dir", "jax_default_matmul_precision")}
    spec = importlib.util.spec_from_file_location("jax_run_mc_vision", ROOT / "scripts" / "run_mc_vision.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for k, v in keep.items():
        jax.config.update(k, v)
    return mod


def _fields(port, ref, path=""):
    """Every field of the port's config equals the JAX config's."""
    for f in dataclasses.fields(port):
        v, r = getattr(port, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(v):
            _fields(v, r, f"{path}{f.name}.")
        else:
            assert v == r, f"{path}{f.name}: {v!r} != {r!r}"


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "sparse"])
def test_scene_config_matches_jax(jmc, dense):
    for scene in SCENES:
        cfg, render = mc.scene_config(scene, dense)
        j_cfg, j_render = jmc.scene_config(scene, dense)
        _fields(cfg, j_cfg, f"{scene}: ")
        assert render == j_render, scene
    with pytest.raises(SystemExit):
        mc.scene_config("forest", dense)


def test_paired_stats_matches_jax(jmc):
    rng = np.random.default_rng(5)
    on = np.abs(rng.normal(0.1, 0.03, size=(7, 2)))
    off = np.abs(rng.normal(0.12, 0.03, size=(7, 2)))
    on[3, 0] = np.nan      # a diverged ON seed is left out pairwise
    off[5, 1] = np.inf
    for a, b in ((on, off), (on[:1], off[:1]), (on[3:4], off[3:4])):
        np.testing.assert_equal(mc.paired_stats(a, b), jmc.paired_stats(a, b))   # NaN std of one pair too


def test_run_variant_matches_jax_on_its_draws(jmc, monkeypatch):
    from ov_plane_tpu.frontend.fused import FusedVisionDriver as JDriver
    from ov_plane_tpu.sim.simulator import NoiseParams, apply_noise, build_sim

    cfg, render = mc.scene_config("tabletop", False)
    j_cfg, _ = jmc.scene_config("tabletop", False)
    B, seed = 2, 17
    scene = build_sim(j_cfg, max_obs=j_cfg.tpu.max_obs_per_frame)
    arrays = {k: np.asarray(v) for k, v in scene._asdict().items()}
    truth = convert.sim_from_arrays(arrays, noisy=False, device="cpu")
    frames = mc.render_frames(cfg, truth, render, PARITY_FRAMES, "cpu")

    # JAX's own IMU draws, as its run_variant makes them, carried across.
    noise = NoiseParams(sigma_w=j_cfg.imu_noises.sigma_w, sigma_a=j_cfg.imu_noises.sigma_a,
                        sigma_wb=j_cfg.imu_noises.sigma_wb, sigma_ab=j_cfg.imu_noises.sigma_ab,
                        sigma_pix=j_cfg.msckf_options.sigma_pix, dt_imu=1.0 / j_cfg.sim.freq_imu)
    draws = [apply_noise(scene, k, noise) for k in jax.random.split(jax.random.PRNGKey(seed), B)]
    sim = convert.sim_from_arrays(convert.stack_streams([{k: np.asarray(v) for k, v in d._asdict().items()}
                                                         for d in draws]), device="cpu")

    tracks = []
    step_batch = JDriver.step_batch

    def recording(self, *a, **k):
        res = step_batch(self, *a, **k)
        tracks.append((np.asarray(res[2].ids), np.asarray(res[2].valid)))
        return res

    monkeypatch.setattr(JDriver, "step_batch", recording)
    monkeypatch.setenv("OVP_IMG_WIRE", "f32")
    monkeypatch.setenv("OVP_KLT_SAMPLER", "mm")
    exact = functools.partial(mc.FusedVisionDriver, sampler="mm", img_wire="f32")
    monkeypatch.setattr(mc, "FusedVisionDriver", exact)
    j_ates = jmc.run_variant(j_cfg, scene, list(frames), B, seed, True, jax.numpy.float64, "jax")
    run = mc.run_variant(cfg, truth, frames, B, seed, True, torch.float64, "port", device="cpu", sim=sim)
    assert len(tracks) == PARITY_FRAMES
    for i, (ids, valid) in enumerate(tracks):
        np.testing.assert_array_equal(run.ids[i], ids, err_msg=f"ids, frame {i + 1}")
        np.testing.assert_array_equal(run.valid[i], valid, err_msg=f"valid, frame {i + 1}")
    # The ATE in the script's units: the position within 1e-6 m (1.805e-8 m
    # read), the orientation within ATE_DEG_TOL: the posyaw fit's yaw over 6
    # frames of a short arc turns the same pose difference into 4.431e-5 deg.
    diff = np.abs(np.asarray(run.ates) - np.asarray(j_ates))
    assert diff[:, 0].max() <= 1e-6, diff
    assert diff[:, 1].max() <= ATE_DEG_TOL, diff
    assert run.valid[-1].sum() > 20 * B          # the frontend tracks real features


def test_main_writes_its_json(tmp_path):
    out = tmp_path / "mc.json"
    runs = {}
    assert mc.main(["--scene", "tabletop", "--seeds", "2", "--max-frames", "3", "--densities", "sparse",
                    "--device", "cpu", "--out", str(out)], runs=runs) == 0
    res = json.loads(out.read_text())
    assert res["scene"] == "tabletop" and res["seeds"] == 2 and list(res["cells"]) == ["sparse"]
    cell = res["cells"]["sparse"]
    assert len(cell["ate_on"]) == len(cell["ate_off"]) == 2
    assert np.isfinite(np.asarray(cell["ate_on"] + cell["ate_off"])).all()
    assert cell["stats"]["n_seeds"] == 2 and "pos_m" in cell["stats"]
    assert set(runs) == {("sparse", "ON"), ("sparse", "OFF")}
    assert runs[("sparse", "ON")].p.shape == (3, 2, 3)
