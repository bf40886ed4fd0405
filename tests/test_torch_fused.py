"""The port's fused vision step and driver against the JAX package.

Two streams of the vision scene (``sim_vision_truth.npz``) at 320×240 with
the intrinsics halved, from frame 40 on: the same 8-bit frames (rendered by
the port, per-stream pixel noise, quantized as the bench quantizes them), the
same noisy IMU windows and the same ground-truth start go through the JAX
``FusedVisionDriver.step_batch`` and the port's, with the image wire and the
KLT sampler set explicitly on both, the frontend in f32 and the filter in
f64. Two settings:

- the f32 wire and the exact f32 sampler 'mm', held to equal integer
  outputs on every frame;
- the main path's u8 wire and bf16 sampler 'mm_bf16' (what 'auto' resolves
  to on 8-bit frames), held to stated fractions of equal ids and flags: XLA
  fuses the u8 decode into FAST's threshold add, and the bf16 weights make
  a patch piecewise constant near its centre, so single corners and tracks
  may differ from the JAX program's.

Run as a script, the file is the vision path's plane witness (see
``witness``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ov_plane_tpu.frontend import fused as j_fused
from ov_plane_tpu.models.feature_bank import FeatureBank as JBank
from ov_plane_tpu.models.manager import VioEngine as JEngine
from ov_plane_tpu.models.manager import init_state_with_gt as j_init
from ov_plane_tpu.utils.config import sim_config as j_sim_config
from ov_plane_tpu_torch import convert
from ov_plane_tpu_torch.frontend import fused as t_fused
from ov_plane_tpu_torch.frontend.synthetic import render_frame_textured
from ov_plane_tpu_torch.models.feature_bank import FeatureBank
from ov_plane_tpu_torch.models.manager import VioEngine, init_state_with_gt
from ov_plane_tpu_torch.ops.quat import quat_2_rot
from ov_plane_tpu_torch.sim import simulator as tsim
from ov_plane_tpu_torch.utils.config import vision_config

torch.set_num_threads(1)
B, K0, N_FRAMES, SNAP = 2, 40, 12, 8     # streams, start frame, frames stepped, frame of the one-step test
WIRE, SAMPLER = "f32", "mm"               # the exact setting
MAIN_WIRE, MAIN_SAMPLER = "u8", "mm_bf16"  # the main path's setting


def _cfg():
    cfg = vision_config()
    cfg.cam_wh = [320, 240]
    cfg.cam_intrinsics = [150.0, 150.0, 160.0, 120.0, 0.0, 0.0, 0.0, 0.0]
    return cfg


def _to_jax_cfg(cfg, jcfg=None):
    """The JAX configuration with every field the port's configuration holds."""
    jcfg = j_sim_config() if jcfg is None else jcfg

    def copy(src, dst):
        for f in dataclasses.fields(src):
            v = getattr(src, f.name)
            if dataclasses.is_dataclass(v):
                copy(v, getattr(dst, f.name))
            else:
                setattr(dst, f.name, v)

    copy(cfg, jcfg)
    return jcfg


@pytest.fixture(scope="module")
def inputs():
    return make_inputs()


def _quantize(img, noise):
    x = np.clip(img[None] + noise, 0.0, 1.0)
    return np.rint(x * np.float32(255.0)) * np.float32(1.0 / 255.0)   # the bench's camera ADC


def _window(imu_t, imu_w, imu_a, s0, W, n_streams):
    """One frame's IMU window, padded with t = inf: imu_w/imu_a are [B, T, 3]
    (or [T, 3], shared by every stream)."""
    m = min(W, imu_t.shape[0] - s0)
    it = np.full((n_streams, W), np.inf)
    iw = np.zeros((n_streams, W, 3))
    ia = np.zeros((n_streams, W, 3))
    it[:, :m] = imu_t[s0:s0 + m]
    iw[:, :m] = imu_w[..., s0:s0 + m, :]
    ia[:, :m] = imu_a[..., s0:s0 + m, :]
    return it, iw, ia


def make_inputs():
    cfg = _cfg()
    truth = tsim.load_scene(tsim.VISION_SCENE_PATH, device="cpu")
    sim = tsim.apply_noise(truth, tsim.noise_params(cfg), B, torch.Generator().manual_seed(11))
    rng = np.random.default_rng(12)
    noise = rng.normal(0.0, 0.01, (B, 240, 320)).astype(np.float32)
    frames = []
    for i in range(K0 + 1, K0 + N_FRAMES + 1):
        img = render_frame_textured(truth.plane_corners, truth.plane_normal, truth.plane_d,
                                    quat_2_rot(truth.gt_q[i]), truth.gt_p[i], np.eye(3), np.zeros(3),
                                    cfg.cam_intrinsics, tuple(cfg.cam_wh)).numpy()
        frames.append(_quantize(img, noise))
    W = cfg.tpu.max_imu_per_frame
    imu_t, imu_w, imu_a = truth.imu_t.numpy(), sim.imu_w.numpy(), sim.imu_a.numpy()
    windows = [(*_window(imu_t, imu_w, imu_a, int(truth.imu_window_start[i]), W, B),
                np.full(B, float(truth.cam_t_imu[i]))) for i in range(K0 + 1, K0 + N_FRAMES + 1)]
    start = dict(t0=np.full(B, float(truth.cam_t_imu[K0])), q0=np.tile(truth.gt_q[K0].numpy(), (B, 1)),
                 p0=np.tile(truth.gt_p[K0].numpy(), (B, 1)), v0=np.tile(truth.gt_v[K0].numpy(), (B, 1)),
                 bg0=sim.gt_bg_cam[:, K0].numpy(), ba0=sim.gt_ba_cam[:, K0].numpy())
    gt = (truth.gt_q[K0 + 1:K0 + N_FRAMES + 1].numpy(), truth.gt_p[K0 + 1:K0 + N_FRAMES + 1].numpy())
    return cfg, frames, windows, start, gt


def _record(drv, pull, out, labels):
    return dict(pull=np.asarray(pull).copy(), counters=np.array(drv.last_counters, copy=True),
                p=np.asarray(out.p, np.float64), q=np.asarray(out.q, np.float64), labels=labels)


def _labels(drv):
    return tuple(np.array(a, copy=True) for a in (drv._label_ids, drv._label_pid, drv._merge_from, drv._merge_into))


@pytest.fixture(scope="module")
def jax_run(inputs):
    return run_jax(inputs)


def run_jax(inputs, wire=WIRE, sampler=SAMPLER, jcfg=None, dtype=jnp.float64):
    """The JAX driver over ``inputs`` (streams and frames as given there);
    returns the per-frame records, the (state, bank, frontend) before frame
    SNAP, the driver and the engine."""
    cfg, frames, windows, start, _ = inputs
    n_streams = frames[0].shape[0]
    jcfg = _to_jax_cfg(cfg, jcfg)
    eng = JEngine.from_config(jcfg)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OVP_IMG_WIRE", wire)
        mp.setenv("OVP_KLT_SAMPLER", sampler)
        drv = j_fused.FusedVisionDriver(jcfg, eng, batch=n_streams)
    sts = [j_init(eng, jcfg, t0=start["t0"][b], q0=start["q0"][b], p0=start["p0"][b], v0=start["v0"][b],
                  bg0=start["bg0"][b], ba0=start["ba0"][b], dtype=dtype) for b in range(n_streams)]
    state = jax.tree.map(lambda *x: jnp.stack(x), *sts)
    bank = jax.tree.map(lambda x: jnp.stack([x] * n_streams),
                        JBank.create(jcfg.tpu.max_features, eng.layout.max_clones, dtype=dtype))
    fev = jax.tree.map(lambda x: jnp.stack([x] * n_streams), drv.init_frontend())
    recs, snap = [], None
    for k in range(len(frames)):
        if k == SNAP:
            snap = (state, bank, fev)
        labels = _labels(drv)
        state, bank, fev, out = drv.step_batch(state, bank, fev, frames[k], *windows[k])
        recs.append(_record(drv, drv._pending_pull, out, labels))
    drv.flush_stream()
    return recs, snap, drv, eng


@pytest.fixture(scope="module")
def port_run(inputs):
    return run_port(inputs)


def run_port(inputs, wire=WIRE, sampler=SAMPLER, dtype=torch.float64, **driver_args):
    cfg, frames, windows, start, _ = inputs
    n_streams = frames[0].shape[0]
    eng = VioEngine.from_config(cfg, device="cpu")
    drv = t_fused.FusedVisionDriver(cfg, eng, n_streams, sampler=sampler, img_wire=wire, **driver_args)
    state = init_state_with_gt(eng, cfg, **start, dtype=dtype, device="cpu")
    bank = FeatureBank.create(cfg.tpu.max_features, eng.layout.max_clones, n_streams, dtype, "cpu")
    fev = drv.init_frontend()
    recs = []
    for k in range(len(frames)):
        labels = _labels(drv)
        state, bank, fev, out = drv.step_batch(state, bank, fev, frames[k], *windows[k])
        recs.append(_record(drv, drv._pending[0], out, labels))
    drv.flush_stream()
    return recs, drv


@pytest.fixture(scope="module")
def main_runs(inputs):
    """Both drivers at the main path's wire and sampler."""
    return run_jax(inputs, MAIN_WIRE, MAIN_SAMPLER)[0], run_port(inputs, MAIN_WIRE, MAIN_SAMPLER)[0]


def _rows(pull):
    return dict(ids=pull[:, :-3, 0], uv=pull[:, :-3, 1:3], valid=pull[:, :-3, 3], p3=pull[:, :-3, 4:7],
                ok3=pull[:, :-3, 7], counters=pull[:, -3], pose=pull[:, -2:])


def test_driver_matches_jax_over_12_frames(jax_run, port_run, inputs):
    jrecs, *_ = jax_run
    trecs, tdrv = port_run
    gt_q, gt_p = inputs[4]
    worst = dict(uv=0.0, p=0.0, q=0.0)
    for k, (j, t) in enumerate(zip(jrecs, trecs)):
        for name, a, b in zip(("label_ids", "label_pid", "merge_from", "merge_into"), j["labels"], t["labels"]):
            np.testing.assert_array_equal(b, a, err_msg=f"frame {k}: {name}")
        jr, tr = _rows(j["pull"]), _rows(t["pull"])
        for name in ("ids", "valid", "ok3", "counters"):
            np.testing.assert_array_equal(tr[name], jr[name], err_msg=f"frame {k}: {name}")
        np.testing.assert_array_equal(t["counters"], j["counters"], err_msg=f"frame {k}: the 9 pulled counters")
        live = jr["valid"] > 0.5
        worst["uv"] = max(worst["uv"], float(np.abs(tr["uv"] - jr["uv"])[live].max(initial=0.0)))
        worst["p"] = max(worst["p"], float(np.abs(t["p"] - j["p"]).max()))
        worst["q"] = max(worst["q"], float(np.abs(t["q"] - j["q"]).max()))
    n_lab = sum(int((r["labels"][0] >= 0).sum()) for r in jrecs)
    n_valid = sum(int(_rows(r["pull"])["valid"].sum()) for r in jrecs)
    print(f"{N_FRAMES} frames x {B} streams: {n_valid} valid slot-frames, {n_lab} plane labels fed; "
          f"max |d uv| {worst['uv']:.3e} px, |d p| {worst['p']:.3e} m, |d q| {worst['q']:.3e}; "
          f"final position error {np.abs(jrecs[-1]['p'] - gt_p[-1]).max():.3f} m")
    assert worst["uv"] <= 1e-3 and worst["p"] <= 1e-4 and worst["q"] <= 1e-5
    # The path did its work: tracks, triangulations for the detector, plane labels.
    assert n_valid > 500 and n_lab > 0
    assert tdrv.n_pulls == N_FRAMES


def test_driver_at_the_main_path_wire_and_sampler(main_runs):
    """The u8 wire and the bf16 sampler, as the main path runs them. The
    first two frames agree on every integer output. Then single tracks part:
    the JAX bf16 tracker parts from itself by up to 1e-2 px when its start
    moves by one ulp (``test_torch_frontend.test_klt_track``), a lost or kept
    track shifts the ids of every later corner, and XLA fuses the u8 decode
    into FAST's threshold add. So later frames are held to fractions and to
    a pose tolerance, each about three times the margin seen: valid flags
    equal on ≥ 95 % of slot-frames (97.4 % seen), ≥ 75 % of the JAX tracks
    with a port track within 0.1 px (83.2 % seen), |Δp| ≤ 5e-3 m (1.55e-3
    seen) and |Δq| ≤ 2e-3 (6.6e-4 seen) over the 12 frames."""
    jrecs, trecs = main_runs
    for k in range(2):
        jr, tr = _rows(jrecs[k]["pull"]), _rows(trecs[k]["pull"])
        for name in ("ids", "valid", "ok3", "counters"):
            np.testing.assert_array_equal(tr[name], jr[name], err_msg=f"frame {k}: {name}")
    n_slots = n_valid_eq = n_tracks = n_near = 0
    dp = dq = 0.0
    for k, (j, t) in enumerate(zip(jrecs, trecs)):
        for a, b in zip(j["labels"], t["labels"]):
            np.testing.assert_array_equal(b, a, err_msg=f"frame {k}: labels")
        jr, tr = _rows(j["pull"]), _rows(t["pull"])
        n_slots += jr["valid"].size
        n_valid_eq += int((jr["valid"] == tr["valid"]).sum())
        for s in range(jr["valid"].shape[0]):
            uj, ut = jr["uv"][s][jr["valid"][s] > 0.5], tr["uv"][s][tr["valid"][s] > 0.5]
            d = np.abs(uj[:, None] - ut[None]).max(-1).min(1, initial=np.inf)
            n_tracks += len(uj)
            n_near += int((d <= 0.1).sum())
        dp, dq = max(dp, float(np.abs(t["p"] - j["p"]).max())), max(dq, float(np.abs(t["q"] - j["q"]).max()))
    print(f"{MAIN_WIRE}/{MAIN_SAMPLER}: valid equal on {n_valid_eq} of {n_slots} slot-frames, "
          f"{n_near} of {n_tracks} JAX tracks with a port track within 0.1 px, |d p| {dp:.3e} m, |d q| {dq:.3e}")
    assert n_valid_eq >= 0.95 * n_slots and n_near >= 0.75 * n_tracks and n_tracks > 500
    assert dp <= 5e-3 and dq <= 2e-3


def test_one_fused_step_from_the_same_state(jax_run, inputs):
    """One ``fused_vision_step`` of the port from the JAX run's state, bank and
    tracker state before frame SNAP (carried across by ``convert``), with the
    inputs the JAX driver packed for that frame."""
    cfg, frames, windows, _, _ = inputs
    jrecs, (jst, jbk, jfev), jdrv, jeng = jax_run
    arrays = lambda x: {f.name: np.asarray(getattr(x, f.name)) for f in dataclasses.fields(x)  # noqa: E731
                        if not isinstance(getattr(x, f.name), (int, tuple)) and f.name != "layout"}
    eng = VioEngine.from_config(cfg, device="cpu")
    state = convert.state_from_arrays(arrays(jst), eng.layout, device="cpu")
    bank = convert.bank_from_arrays(arrays(jbk), device="cpu")
    fev_arrays = {k: v for k, v in arrays(jfev).items() if k != "pyr"}
    pyr = {"padded": [np.asarray(x) for x in jfev.pyr.padded],
           "grads": [(np.asarray(gx), np.asarray(gy)) for gx, gy in jfev.pyr.grads]}
    fev = convert.frontend_from_arrays(dict(fev_arrays, pyr=pyr), device="cpu")
    drv = t_fused.FusedVisionDriver(cfg, eng, B, sampler=SAMPLER, img_wire=WIRE)
    W = cfg.tpu.max_imu_per_frame
    pay = t_fused._pack_payload(drv.vopts, W, B, *windows[SNAP], *jrecs[SNAP]["labels"])
    img_w = torch.as_tensor(t_fused._pack_image(drv.vopts, frames[SNAP]))
    ins = t_fused._unpack_inputs(drv.vopts, W, img_w, torch.as_tensor(pay))
    _, _, fev1, out, pull = t_fused.fused_vision_step(eng, drv.vopts, state, bank, fev, *ins)
    jr, tr = _rows(jrecs[SNAP]["pull"]), _rows(pull.numpy())
    for name in ("ids", "valid", "ok3", "counters"):
        np.testing.assert_array_equal(tr[name], jr[name], err_msg=name)
    live = jr["valid"] > 0.5
    np.testing.assert_allclose(tr["uv"][live], jr["uv"][live], rtol=0, atol=1e-4)
    # The whole-track systems accumulate in f32 (JAX's with fused
    # multiply-adds) and are solved at a condition number up to 8000: the
    # triangulations agree to about 1e-5 m, the pose rows to 1e-6 m.
    np.testing.assert_allclose(tr["p3"], jr["p3"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(tr["pose"], jr["pose"], rtol=0, atol=1e-6)
    print(f"one step: max|d uv| {np.abs(tr['uv'] - jr['uv'])[live].max():.3e} px, "
          f"max|d p3| {np.abs(tr['p3'] - jr['p3']).max():.3e} m, "
          f"max|d pose| {np.abs(tr['pose'] - jr['pose']).max():.3e}")
    np.testing.assert_allclose(out.p.numpy(), jrecs[SNAP]["p"], rtol=0, atol=1e-6)
    assert live.sum() > 40 and (jr["ok3"] > 0.5).sum() >= 3


def test_detector_thread_pool_matches_serial(port_run, inputs):
    """``plane_threads=2`` (the per-stream Delaunay calls on a thread pool)
    feeds the step the same labels and merges as the serial detector."""
    trecs, _ = port_run
    srecs, sdrv = run_port(inputs, plane_threads=2)
    assert sdrv._plane_pool is not None
    sdrv.close()
    for k, (a, b) in enumerate(zip(trecs, srecs)):
        for x, y in zip(a["labels"], b["labels"]):
            np.testing.assert_array_equal(y, x, err_msg=f"frame {k}")
        np.testing.assert_array_equal(b["pull"], a["pull"], err_msg=f"frame {k}")


def test_pack_round_trip():
    """The image wire and the f32 payload: u8 is lossless for an 8-bit source,
    f16 within its precision, and the payload (inf-padded IMU windows, ids,
    labels, merges, t_new) comes back as packed, in f32."""
    cfg = _cfg()
    eng = VioEngine.from_config(cfg, device="cpu")
    rng = np.random.default_rng(13)
    img = (np.rint(rng.random((B, 240, 320)) * 255) / 255).astype(np.float32)
    W = cfg.tpu.max_imu_per_frame
    it = np.full((B, W), np.inf)
    it[:, :40] = 12.0 + np.arange(40) / 400.0
    iw, ia = rng.normal(size=(B, W, 3)), rng.normal(size=(B, W, 3))
    li = rng.integers(-1, 5000, (B, 64))
    lp, mf, mi = rng.integers(-1, 9, (B, 64)), rng.integers(-1, 9, (B, 8)), rng.integers(-1, 9, (B, 8))
    tn = np.array([12.1, 12.2])
    for wire, tol in (("u8", 2.0**-23), ("f16", 2.5e-4), ("f32", 0.0)):
        drv = t_fused.FusedVisionDriver(cfg, eng, B, sampler="mm", img_wire=wire)
        staged = drv.stage_image(img)
        assert staged.dtype == {"u8": torch.uint8, "f16": torch.float16, "f32": torch.float32}[wire]
        pay = torch.as_tensor(t_fused._pack_payload(drv.vopts, W, B, it, iw, ia, tn, li, lp, mf, mi))
        out = t_fused._unpack_inputs(drv.vopts, W, staged, pay)
        assert float((out[0] - torch.as_tensor(img)).abs().max()) <= tol
        for got, want in zip(out[1:], (it, iw, ia, tn, li, lp, mf, mi)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want, np.float32).astype(got.numpy().dtype))


def witness(n_streams=4, n_frames=80, noise_seed=5, first_stream=0, filter_bits=64):
    """The vision path's plane witness: the bench's own vision inputs through
    both drivers on the CPU, and each frame's plane counters side by side.

    As ``bench.py`` vision mode builds them: the JAX ``build_sim`` of the
    bench's configuration (its one noisy IMU draw, shared by every stream),
    80 frames at 640×480 (rendered by the port, which matches the JAX
    renderer), the per-stream pixel noise ``default_rng(noise_seed)`` draws
    for 64 streams (streams first_stream.. of it; the bench's seed is 5),
    quantized to 8 bits, the start at frame 0's truth. Both drivers run the
    main path's u8 wire and bf16 sampler with the filter in f64 (or f32:
    ``filter_bits``). Prints, per
    frame and summed over the streams, the pulled counters n_plane_init (0),
    n_plane_constraints (1) and the largest n_planes (2) of each side, and
    the plane labels the host detector fed to the step."""
    import sys
    from pathlib import Path

    from ov_plane_tpu.sim.simulator import build_sim

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from test_torch_scene import _vision_cfg

    jcfg = _vision_cfg()
    cfg = vision_config()
    sim = build_sim(jcfg, max_obs=cfg.tpu.max_obs_per_frame)
    truth = tsim.load_scene(tsim.VISION_SCENE_PATH, device="cpu")
    noise = np.random.default_rng(noise_seed).normal(0.0, 0.01, (64, 480, 640)).astype(np.float32)
    noise = noise[first_stream:first_stream + n_streams]
    frames = []
    for i in range(1, n_frames + 1):
        img = render_frame_textured(truth.plane_corners, truth.plane_normal, truth.plane_d,
                                    quat_2_rot(truth.gt_q[i]), truth.gt_p[i], np.eye(3), np.zeros(3),
                                    cfg.cam_intrinsics, tuple(cfg.cam_wh)).numpy()
        frames.append(_quantize(img, noise))
    imu_t, imu_w, imu_a = (np.asarray(x) for x in (sim.imu_t, sim.imu_w, sim.imu_a))
    W = cfg.tpu.max_imu_per_frame
    windows = [(*_window(imu_t, imu_w, imu_a, int(sim.imu_window_start[i]), W, n_streams),
                np.full(n_streams, float(sim.cam_t_imu[i]))) for i in range(1, n_frames + 1)]
    start = {k: np.tile(np.asarray(v), (n_streams, 1)) for k, v in
             dict(q0=sim.gt_q[0], p0=sim.gt_p[0], v0=sim.gt_v[0], bg0=sim.gt_bg_cam[0], ba0=sim.gt_ba_cam[0]).items()}
    start["t0"] = np.full(n_streams, float(sim.cam_t_imu[0]))
    inputs = (cfg, frames, windows, start, None)
    jdt, tdt = (jnp.float64, torch.float64) if filter_bits == 64 else (jnp.float32, torch.float32)
    runs = {"jax": run_jax(inputs, MAIN_WIRE, MAIN_SAMPLER, jcfg=jcfg, dtype=jdt)[0],
            "port": run_port(inputs, MAIN_WIRE, MAIN_SAMPLER, dtype=tdt)[0]}
    print(f"plane witness: streams {first_stream}-{first_stream + n_streams - 1} x {n_frames} frames, 640x480, "
          f"noise seed {noise_seed}, {MAIN_WIRE} wire, {MAIN_SAMPLER} sampler, filter f{filter_bits}")
    print("frame | jax: init constraints max_planes labels | port: init constraints max_planes labels")
    total = {}
    for k in range(n_frames):
        row = []
        for side, recs in runs.items():
            c = recs[k]["counters"]
            vals = (int(c[:, 0].sum()), int(c[:, 1].sum()), int(c[:, 2].max()), int((recs[k]["labels"][0] >= 0).sum()))
            t = total.setdefault(side, [0, 0, 0, 0])
            t[:] = t[0] + vals[0], t[1] + vals[1], max(t[2], vals[2]), t[3] + vals[3]
            row.append(" ".join(f"{v:4d}" for v in vals))
        print(f"{k + 1:5d} | {row[0]} | {row[1]}")
    for side, t in total.items():
        print(f"{side} total: plane_init={t[0]} constraints={t[1]} max_planes={t[2]} labels={t[3]}")


if __name__ == "__main__":
    # env JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_fused.py \
    #     [n_streams n_frames noise_seed first_stream filter_bits]
    import sys

    jax.config.update("jax_enable_x64", True)
    torch.set_num_threads(4)
    witness(*(int(a) for a in sys.argv[1:6]))
