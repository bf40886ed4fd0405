"""The fused path's plane update, port against JAX, on the tabletop scene.

The JAX package's plane-firing scene (``tests/test_fused_planes.py``: the
tabletop trajectory under the reference's stock plane gates, committed as
``sim_tabletop_truth.npz``) through ``FusedVisionDriver.step_stream`` of both
packages, one stream, frontend in f32, filter in f64: the same frames
(rendered by the port with the scene's texture: ``texture_cell=0.1``, a
``(0.05, 0.12, 0.30)`` speckle layer and a 0.12 one, no blobs), the same
noisy IMU windows and the same ground-truth start. The JAX driver runs all
46 frames of the scene; the port's starts from the JAX run after frame 36
(filter state, bank and frontend state carried across by ``convert``, the
host detector's state, the labels and merges it feeds the next step and the
pipelined pull of frame 36 copied) and runs frames 37-46. The plane stages
open after the 2 s delay (frame 40); the first CP plane enters the state at
frame 42 and its constraint updates follow. Held: every plane counter, the
MSCKF count, the bank and clone counts, the pulled counters and the host
detector's labels equal on every frame of the port's run; the pose within
1e-5 m and 1e-5 (the f32 tracks and whole-track solves differ in their last
bits, XLA fusing multiply-adds, and the filter carries that).
"""

import copy

import dataclasses

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
from ov_plane_tpu_torch.utils.config import tabletop_config

LAST = 46                       # the scene's last frame; frames 1 .. LAST are stepped
CARRY = 36                      # the port starts from the JAX run after this frame
N_LAG = 18                      # frames of the label-lag test (labels are fed from frame 14)
LAYERS = dict(texture_cell=0.1, speckle_cells=((0.05, 0.12, 0.30), 0.12))
COUNTERS = ("n_plane_init", "n_plane_constraints", "n_planes", "n_plane_merges", "n_msckf_used", "n_bank",
            "n_clones")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _to_jax_cfg(cfg):
    jcfg = j_sim_config()

    def copy(src, dst):
        for f in dataclasses.fields(src):
            v = getattr(src, f.name)
            if dataclasses.is_dataclass(v):
                copy(v, getattr(dst, f.name))
            else:
                setattr(dst, f.name, v)

    copy(cfg, jcfg)
    return jcfg


def make_inputs(last=LAST):
    """(cfg, frames [h, w] f32 of frames 1..last, their IMU windows, the ground-truth start)."""
    cfg = tabletop_config()
    truth = tsim.load_scene(tsim.TABLETOP_SCENE_PATH, device="cpu")
    sim = tsim.apply_noise(truth, tsim.noise_params(cfg), 1, torch.Generator().manual_seed(21))
    R_ItoC = quat_2_rot(torch.tensor(cfg.cam_extrinsics[0:4], dtype=torch.float64))
    p_IinC = torch.tensor(cfg.cam_extrinsics[4:7], dtype=torch.float64)
    frames, windows = [], []
    W = cfg.tpu.max_imu_per_frame
    imu_t, imu_w, imu_a = truth.imu_t.numpy(), sim.imu_w[0].numpy(), sim.imu_a[0].numpy()
    for i in range(1, last + 1):
        frames.append(render_frame_textured(truth.plane_corners, truth.plane_normal, truth.plane_d,
                                            quat_2_rot(truth.gt_q[i]), truth.gt_p[i], R_ItoC, p_IinC,
                                            cfg.cam_intrinsics, tuple(cfg.cam_wh), **LAYERS).numpy())
        s0 = int(truth.imu_window_start[i])
        m = min(W, imu_t.shape[0] - s0)
        it, iw, ia = np.full(W, np.inf), np.zeros((W, 3)), np.zeros((W, 3))
        it[:m], iw[:m], ia[:m] = imu_t[s0:s0 + m], imu_w[s0:s0 + m], imu_a[s0:s0 + m]
        windows.append((it, iw, ia, float(truth.cam_t_imu[i])))
    start = dict(t0=float(truth.cam_t_imu[0]), q0=truth.gt_q[0].numpy(), p0=truth.gt_p[0].numpy(),
                 v0=truth.gt_v[0].numpy(), bg0=sim.gt_bg_cam[0, 0].numpy(), ba0=sim.gt_ba_cam[0, 0].numpy())
    return cfg, frames, windows, start


def _record(drv, out, labels):
    return dict(out={k: np.asarray(getattr(out, k)).reshape(-1)[0] for k in COUNTERS},
                p=np.asarray(out.p, np.float64).reshape(3), q=np.asarray(out.q, np.float64).reshape(4),
                counters=np.array(drv.last_counters, copy=True), labels=labels)


def _arrays(x):
    """A JAX pytree's array fields, with a stream dimension of one added."""
    return {f.name: np.array(getattr(x, f.name))[None] for f in dataclasses.fields(x)
            if not isinstance(getattr(x, f.name), (int, tuple)) and f.name != "layout"}


def _snapshot(drv, state, bank, fev):
    """What the port's driver needs to go on from the JAX driver's place."""
    fev_arrays = {k: v for k, v in _arrays(fev).items() if k != "pyr"}
    pyr = {"padded": [np.array(x)[None] for x in fev.pyr.padded],
           "grads": [(np.array(gx)[None], np.array(gy)[None]) for gx, gy in fev.pyr.grads]}
    tr = drv.trackers[0]
    return dict(state=_arrays(state), bank=_arrays(bank), fev=dict(fev_arrays, pyr=pyr),
                feed={k: np.array(getattr(drv, k), copy=True)
                      for k in ("_label_ids", "_label_pid", "_merge_from", "_merge_into")},
                tracker={k: np.array(getattr(tr, k), copy=True)
                         for k in ("_ids", "_hist", "_hist_cnt", "_hist_ptr", "_plane")},
                plane_id=tr.curr_plane_id, old_planes=copy.deepcopy(tr.plane_to_oldplanes),
                pull=np.array(drv._pending_pull, np.float32)[None])


def run_jax(inputs, carry=CARRY):
    """The JAX driver over every frame; returns its records, its last
    counters and its snapshot after frame ``carry``."""
    cfg, frames, windows, start = inputs
    jcfg = _to_jax_cfg(cfg)
    eng = JEngine.from_config(jcfg)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OVP_IMG_WIRE", "f32")
        mp.setenv("OVP_KLT_SAMPLER", "mm")
        drv = j_fused.FusedVisionDriver(jcfg, eng)
    state = j_init(eng, jcfg, **start)
    bank = JBank.create(jcfg.tpu.max_features, eng.layout.max_clones)
    fev = drv.init_frontend()
    recs, snap = [], None
    for k, (img, (it, iw, ia, tn)) in enumerate(zip(frames, windows)):
        labels = np.array(drv._label_ids[0], copy=True)
        state, bank, fev, out = drv.step_stream(state, bank, fev, img, it, iw, ia, tn)
        recs.append(_record(drv, out, labels))
        if k + 1 == carry:
            snap = _snapshot(drv, state, bank, fev)
    drv.flush_stream()
    return recs, np.array(drv.last_counters, copy=True), snap


def run_port(inputs, pipelined=True, snap=None):
    """The port's driver over the frames, from the start or, given a JAX
    snapshot, from its place (the frames after it)."""
    cfg, frames, windows, start = inputs
    eng = VioEngine.from_config(cfg, device="cpu")
    drv = t_fused.FusedVisionDriver(cfg, eng, 1, sampler="mm", img_wire="f32")
    if snap is None:
        state = init_state_with_gt(eng, cfg, **{k: np.asarray(v)[None] for k, v in start.items()}, device="cpu")
        bank = FeatureBank.create(cfg.tpu.max_features, eng.layout.max_clones, 1, torch.float64, "cpu")
        fev = drv.init_frontend()
    else:
        state = convert.state_from_arrays(snap["state"], eng.layout, device="cpu")
        bank = convert.bank_from_arrays(snap["bank"], device="cpu")
        fev = convert.frontend_from_arrays(snap["fev"], device="cpu")
        for k, v in snap["feed"].items():
            getattr(drv, k)[:] = v
        # The detector's rows: the JAX tracker's first rows (rows are taken
        # first-free, so the live ones sit at the front).
        tr = drv.tracker
        rows = min(tr.capacity, snap["tracker"]["_ids"].shape[0])
        assert (snap["tracker"]["_ids"][rows:] < 0).all(), "a live detector row beyond the port's capacity"
        for k, v in snap["tracker"].items():
            getattr(tr, k)[0, :rows] = v[:rows]
        tr.curr_plane_id[0] = snap["plane_id"]
        tr.plane_to_oldplanes[0] = copy.deepcopy(snap["old_planes"])
        drv._pending = (torch.from_numpy(snap["pull"].copy()), None)
        frames, windows = frames[CARRY:], windows[CARRY:]
    recs = []
    for img, (it, iw, ia, tn) in zip(frames, windows):
        labels = np.array(drv._label_ids[0], copy=True)
        state, bank, fev, out = drv.step_stream(state, bank, fev, img, it, iw, ia, tn, pipelined=pipelined)
        recs.append(_record(drv, out, labels))
    drv.flush_stream()
    return recs, np.array(drv.last_counters, copy=True), drv


@pytest.fixture(scope="module")
def inputs():
    return make_inputs()


@pytest.fixture(scope="module")
def jax_run(inputs):
    return run_jax(inputs)


def test_step_stream_plane_update_matches_jax(inputs, jax_run):
    jrecs, jlast, snap = jax_run
    trecs, tlast, tdrv = run_port(inputs, snap=snap)
    jrecs = jrecs[CARRY:]
    assert len(trecs) == len(jrecs) == LAST - CARRY
    dp = dq = 0.0
    for k, (j, t) in enumerate(zip(jrecs, trecs)):
        frame = CARRY + k + 1
        np.testing.assert_array_equal(t["labels"], j["labels"], err_msg=f"frame {frame}: plane labels fed")
        for name in COUNTERS:
            assert t["out"][name] == j["out"][name], (frame, name, t["out"][name], j["out"][name])
        np.testing.assert_array_equal(t["counters"], j["counters"], err_msg=f"frame {frame}: pulled counters")
        dp, dq = max(dp, float(np.abs(t["p"] - j["p"]).max())), max(dq, float(np.abs(t["q"] - j["q"]).max()))
    np.testing.assert_array_equal(tlast, jlast)
    inits, constr, planes = ([int(r["out"][k]) for r in jrecs]
                             for k in ("n_plane_init", "n_plane_constraints", "n_planes"))
    print(f"frames {CARRY + 1}-{LAST}: plane inits {inits}, constraint updates {constr}, planes {planes}; "
          f"|d p| {dp:.3e} m, |d q| {dq:.3e}")
    assert dp <= 1e-5 and dq <= 1e-5
    # The window holds real plane work on both sides: labels reach the step,
    # a CP plane is initialized into the state (not only counted before the
    # delay gate), and constraint updates follow it; none before the window.
    first_plane = next(k for k, n in enumerate(planes) if n > 0)
    assert all(int(r["out"]["n_planes"]) == 0 for r in jax_run[0][:CARRY])
    assert sum(int((r["labels"] >= 0).sum()) for r in jrecs) > 0
    assert first_plane > 0 and inits[first_plane] >= 1
    assert sum(constr[first_plane:]) > 0 and sum(constr[:first_plane]) == 0
    assert tdrv.n_pulls == len(trecs) + 1     # and the carried pull of frame CARRY


def test_step_stream_label_lag(inputs, jax_run):
    """Pipelined, labels reach the step two frames after the frame they were
    detected on; with ``pipelined=False`` one frame after (the JAX
    ``step_stream`` semantics). Before frame 40 the labels do not act on the
    filter (the plane stages wait for the 2 s delay), so both runs track and
    detect alike there: the port's unpipelined labels fed at frame k are the
    ones the JAX pipelined driver feeds at frame k+1."""
    cfg, frames, windows, start = inputs
    sync, _, sdrv = run_port((cfg, frames[:N_LAG], windows[:N_LAG], start), pipelined=False)
    piped = jax_run[0]
    assert sdrv.n_pulls == N_LAG and sum(int((r["labels"] >= 0).sum()) for r in sync) > 0
    for k in range(N_LAG - 1):
        np.testing.assert_array_equal(sync[k]["labels"], piped[k + 1]["labels"], err_msg=f"frame {k + 1}")
    with pytest.raises(ValueError, match="one stream"):
        t_fused.FusedVisionDriver(cfg, VioEngine.from_config(cfg, device="cpu"), 2).step_stream(
            None, None, None, frames[0], *windows[0])
