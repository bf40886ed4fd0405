"""VIO engine of B streams: the per-frame filter step and sequence replay.

Counterpart of ``ov_plane_tpu/models/manager.py`` for the point-MSCKF path
(planes, SLAM landmarks, ZUPT, ArUco, ground-truth injection and calibration
come with later slices of the port and raise here). One frame is

    propagate + clone → undistort + ingest → triage → MSCKF update →
    free consumed tracks → marginalize the oldest clone

over a leading stream dimension B. The step has no host synchronization:
every per-stream decision is a ``torch.where`` select, and per-stream slot
indices are [B] tensors. :func:`run_sequence` is a Python loop over frames.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from ov_plane_tpu_torch.models import feature_bank as fb
from ov_plane_tpu_torch.models.jacobians import JacobianOptions
from ov_plane_tpu_torch.models.msckf import MsckfOptions, msckf_update
from ov_plane_tpu_torch.ops import cams
from ov_plane_tpu_torch.ops.triangulation import TriangulationOptions
from ov_plane_tpu_torch.state.layout import StateLayout
from ov_plane_tpu_torch.state.propagator import PropagatorOptions, marginalize_oldest_clone, propagate_and_clone
from ov_plane_tpu_torch.state.vio_state import VioState, tree_where
from ov_plane_tpu_torch.utils.config import VioConfig
from ov_plane_tpu_torch.utils.torchenv import resolve_device


# Profiler ranges of the step's stages (torch.profiler.record_function), in order.
STAGES = ("step.propagate_and_clone", "step.ingest", "step.triage", "step.msckf_update", "step.marginalize")


class FrameData(NamedTuple):
    """One camera frame of every stream."""

    imu_t: torch.Tensor      # [B, I] IMU window covering [state.t, t_new]
    imu_w: torch.Tensor      # [B, I, 3]
    imu_a: torch.Tensor      # [B, I, 3]
    t_new: torch.Tensor      # [B]
    obs_id: torch.Tensor     # [B, O] int (-1 pad)
    obs_uv: torch.Tensor     # [B, O, 2]
    obs_plane: torch.Tensor  # [B, O] int


class StepOutput(NamedTuple):
    t: torch.Tensor
    q: torch.Tensor             # [B, 4] estimated q_GtoI
    p: torch.Tensor             # [B, 3]
    v: torch.Tensor
    bg: torch.Tensor
    ba: torch.Tensor
    cov_diag_imu: torch.Tensor  # [B, 15]
    n_msckf_used: torch.Tensor  # [B]
    n_clones: torch.Tensor
    n_bank: torch.Tensor
    cov_ori_blk: torch.Tensor   # [B, 3, 3]
    cov_pos_blk: torch.Tensor


@dataclass(frozen=True)
class VioEngine:
    """Static engine parameters derived from VioConfig."""

    layout: StateLayout
    prop_opts: PropagatorOptions
    msckf_opts: MsckfOptions
    cam_model: int
    max_clone_size: int
    max_msckf_in_update: int
    max_msckf_batch: int
    gravity_mag: float
    sigma_w2: float
    sigma_a2: float
    sigma_wb2: float
    sigma_ab2: float
    min_clones_to_update: int
    device: torch.device

    @classmethod
    def from_config(cls, cfg: VioConfig, device="cuda") -> "VioEngine":
        st = cfg.state
        later = {
            "SLAM landmarks (max_slam_features > 0)": st.max_slam_features > 0,
            "plane constraints (use_plane_constraint)": st.use_plane_constraint and (
                st.use_plane_slam_feats or st.use_plane_constraint_msckf),
            "ZUPT (try_zupt)": cfg.try_zupt,
            "ArUco landmarks (use_aruco)": cfg.use_aruco,
            "ground-truth injection (use_groundtruths)": st.use_groundtruths,
            "sharded compression (tpu.shard_axis)": bool(cfg.tpu.shard_axis),
            "feature representations other than GLOBAL_3D": (
                st.feat_rep_msckf != "GLOBAL_3D" or st.feat_rep_slam != "GLOBAL_3D"),
            "online calibration (do_calib_camera_*)": (
                st.do_calib_camera_pose or st.do_calib_camera_intrinsics or st.do_calib_camera_timeoffset),
        }
        for what, on in later.items():
            if on:
                raise NotImplementedError(f"{what} is not ported yet: it comes with a later slice "
                                          "of ov_plane_tpu_torch (see ROADMAP.md queue 1)")
        lay = StateLayout(
            max_clones=st.max_clone_size + 1,  # +1: transient slot between clone and marginalize
            max_slam=1, max_planes=cfg.tpu.max_planes,
            calib_dt=False, calib_pose=False, calib_intr=False,
        )
        tri = TriangulationOptions(
            min_dist=cfg.featinit.min_dist, max_dist=cfg.featinit.max_dist,
            max_cond=cfg.featinit.max_cond_number, refine=cfg.featinit.refine_features,
            max_runs=cfg.featinit.max_runs,
        )
        cam_model = cams.RADTAN if cfg.cam_model == "radtan" else cams.EQUI
        return cls(
            layout=lay,
            prop_opts=PropagatorOptions(use_rk4=st.use_rk4_integration, imu_avg=st.imu_avg,
                                        do_fej=st.do_fej),
            msckf_opts=MsckfOptions(
                jac=JacobianOptions(cam_model=cam_model, do_fej=st.do_fej), tri=tri,
                sigma_px=cfg.msckf_options.sigma_pix,
                chi2_multipler=cfg.msckf_options.chi2_multipler,
                use_info_compression=cfg.tpu.use_info_compression,
            ),
            cam_model=cam_model,
            max_clone_size=st.max_clone_size,
            max_msckf_in_update=st.max_msckf_in_update,
            max_msckf_batch=max(cfg.tpu.max_msckf_update, st.max_msckf_in_update),
            gravity_mag=cfg.gravity_mag,
            sigma_w2=cfg.imu_noises.sigma_w_2, sigma_a2=cfg.imu_noises.sigma_a_2,
            sigma_wb2=cfg.imu_noises.sigma_wb_2, sigma_ab2=cfg.imu_noises.sigma_ab_2,
            min_clones_to_update=min(st.max_clone_size, 5),
            device=resolve_device(device),
        )


def init_state_with_gt(eng: VioEngine, cfg: VioConfig, t0, q0, p0, v0, bg0, ba0,
                       dtype=torch.float64, device="cuda") -> VioState:
    """Ground-truth initialization of B streams (VioManager::initialize_with_gt):
    exact mean, fixed diagonal prior. t0 [B], q0 [B, 4], p0/v0/bg0/ba0 [B, 3]."""
    dev = resolve_device(device)
    as_t = lambda x: torch.as_tensor(x, dtype=dtype, device=dev)  # noqa: E731
    t0 = as_t(t0)
    B = t0.shape[0]
    st = VioState.create(eng.layout, B, dtype, dev)
    imu = torch.cat([as_t(q0), as_t(p0), as_t(v0), as_t(bg0), as_t(ba0)], dim=1)
    d = torch.tensor([0.02**2] * 3 + [0.05**2] * 3 + [0.01**2] * 3 + [0.02**2] * 3 + [0.02**2] * 3,
                     dtype=dtype, device=dev)
    cov = st.cov.clone()
    cov[:, :15, :15] = torch.diag(d)
    return st.replace(
        t=t0.clone(), startup_t=t0.clone(), imu=imu, imu_fej=imu.clone(), cov=cov,
        calib_cam=as_t(cfg.cam_extrinsics).expand(B, 7).clone(),
        cam_zeta=as_t(cfg.cam_intrinsics).expand(B, 8).clone(),
        calib_dt=torch.full((B,), cfg.calib_camimu_dt, dtype=dtype, device=dev),
        last_dt=torch.full((B,), cfg.calib_camimu_dt, dtype=dtype, device=dev),
    )


def _topk_first_index(score: torch.Tensor, k: int):
    """Top-k of integer scores [B, F] with ties broken towards the lower index
    (``jax.lax.top_k`` order; ``torch.topk`` guarantees none): the key
    score·F + (F−1−idx) is unique per row."""
    F = score.shape[-1]
    idx = torch.arange(F, device=score.device)
    key = score.to(torch.int64) * F + (F - 1 - idx)
    _, sel = torch.topk(key, k, dim=-1, largest=True, sorted=True)
    return score.gather(-1, sel), sel


def triage(eng: VioEngine, state: VioState, bank: fb.FeatureBank, cur_slot: torch.Tensor):
    """MSCKF selection (VioManager.cpp:375-506 without SLAM promotion): the
    top max_msckf_in_update of (lost ∪ marg) by track length, padded to the
    static batch M. Returns (sel_idx [B, M], sel_valid [B, M])."""
    B, F = bank.fid.shape
    K = bank.mask.shape[-1]
    M = eng.max_msckf_batch
    active = bank.active & ~bank.is_slam
    seen_now = (bank.mask & fb._slot_onehot(cur_slot, K)[:, None, :]).any(dim=-1)
    lost = active & ~seen_now
    window_full = state.num_clones > eng.max_clone_size
    at_marg = (bank.mask & fb._slot_onehot(state.oldest_clone_slot, K)[:, None, :]).any(dim=-1)
    marg = active & at_marg & window_full[:, None]
    nobs = bank.n_obs
    candidates = (lost | marg) & (nobs >= 2)
    score = torch.where(candidates, nobs, -1)
    k = min(M, F)
    top_scores, sel_idx = _topk_first_index(score, k)
    if k < M:
        top_scores = torch.cat([top_scores, top_scores.new_full((B, M - k), -1)], dim=1)
        sel_idx = torch.cat([sel_idx, sel_idx.new_zeros((B, M - k))], dim=1)
    rank_ok = torch.arange(M, device=score.device) < eng.max_msckf_in_update
    return sel_idx, (top_scores >= 2) & rank_ok


@functools.lru_cache(maxsize=16)
def _imu_constants(eng: VioEngine, dtype: torch.dtype, device: torch.device):
    """(noises [σ_w², σ_a², σ_wb², σ_ab²], gravity) on the device, made once:
    a host-to-device copy inside the step would synchronize the stream."""
    noises = torch.tensor([eng.sigma_w2, eng.sigma_a2, eng.sigma_wb2, eng.sigma_ab2], dtype=dtype, device=device)
    return noises, torch.tensor([0.0, 0.0, eng.gravity_mag], dtype=dtype, device=device)


def step(eng: VioEngine, state: VioState, bank: fb.FeatureBank, frame: FrameData):
    """One camera frame of every stream (do_feature_propagate_update,
    VioManager.cpp:330-986, point path). Returns (state, bank, StepOutput)."""
    if state.cov.device != eng.device:
        raise ValueError(f"state lies on {state.cov.device}, the engine on {eng.device}")
    dev = state.imu.device
    noises, gravity = _imu_constants(eng, state.imu.dtype, dev)

    # 1. Propagate + stochastic clone into a recycled slot.
    with record_function("step.propagate_and_clone"):
        state, new_slot = propagate_and_clone(state, frame.imu_t, frame.imu_w, frame.imu_a, frame.t_new,
                                              noises, gravity, eng.prop_opts)

    # 2. Undistort + ingest at the new slot; non-finite pixels are dropped.
    with record_function("step.ingest"):
        obs_finite = torch.isfinite(frame.obs_uv).all(dim=-1)
        obs_id = torch.where(obs_finite, frame.obs_id, -1)
        obs_uv = torch.where(obs_finite[..., None], frame.obs_uv, 0.0)
        uvn = cams.undistort(obs_uv, state.cam_zeta[:, None, :], eng.cam_model)
        bank = fb.ingest(bank, obs_id, obs_uv, uvn, frame.obs_plane, new_slot)

    # 3. Triage, masked off until enough clones (VioManager.cpp:355).
    with record_function("step.triage"):
        can_update = state.num_clones >= eng.min_clones_to_update
        sel_idx, sel_valid = triage(eng, state, bank, new_slot)
        sel_valid = sel_valid & can_update[:, None]

    # 4. MSCKF update of the selected tracks.
    with record_function("step.msckf_update"):
        sel_mask = fb._take(bank.mask, sel_idx) & sel_valid[..., None]
        state, used, _, _ = msckf_update(state, eng.msckf_opts, fb._take(bank.uv, sel_idx),
                                         fb._take(bank.uvn, sel_idx), sel_mask)

    with record_function("step.marginalize"):
        # 5. Free the consumed rows (to_delete semantics).
        F = bank.fid.shape[1]
        consumed = ((torch.arange(F, device=dev)[None, :, None] == sel_idx[:, None, :])
                    & sel_valid[:, None, :]).any(dim=-1)
        bank = fb.free_rows(bank, consumed)

        # 6. Marginalize the oldest clone if over budget; clear its column.
        marg_slot = state.oldest_clone_slot
        over = state.num_clones > eng.max_clone_size
        state = marginalize_oldest_clone(state, eng.max_clone_size)
        cleared = fb.clear_clone_column(bank, marg_slot)
        bank = tree_where(over, cleared, bank)
        state = state.replace(has_moved=torch.ones_like(state.has_moved))

    diag = torch.diagonal(state.cov, dim1=-2, dim2=-1)
    out = StepOutput(
        t=state.t, q=state.imu[:, 0:4], p=state.imu[:, 4:7], v=state.imu[:, 7:10],
        bg=state.imu[:, 10:13], ba=state.imu[:, 13:16], cov_diag_imu=diag[:, :15],
        n_msckf_used=(used & sel_valid).sum(dim=-1), n_clones=state.num_clones,
        n_bank=bank.active.sum(dim=-1),
        cov_ori_blk=state.cov[:, 0:3, 0:3], cov_pos_blk=state.cov[:, 3:6, 3:6],
    )
    return state, bank, out


def run_sequence(eng: VioEngine, state: VioState, bank: fb.FeatureBank, sim_data, imu_window: int,
                 n_frames: int | None = None):
    """Replay a simulated sequence of B streams (``sim.simulator.SimData``).

    Frame 0 is the initialization frame; frames 1..n_frames are stepped
    (all of them by default). Returns (state, bank, outputs) with every
    output stacked to [B, T, ...].
    """
    total = sim_data.cam_t.shape[-1]
    n_frames = total - 1 if n_frames is None else n_frames
    B = state.imu.shape[0]
    Ti = sim_data.imu_t.shape[-1]
    # The window starts are scene constants kept on the host; a start past
    # the end is clamped as lax.dynamic_slice clamps it.
    starts = np.asarray(sim_data.imu_window_start)
    outs = []
    for i in range(1, n_frames + 1):
        s = int(min(max(int(starts[i]), 0), Ti - imu_window))
        frame = FrameData(
            imu_t=sim_data.imu_t[..., s:s + imu_window].expand(B, imu_window),
            imu_w=sim_data.imu_w[:, s:s + imu_window],
            imu_a=sim_data.imu_a[:, s:s + imu_window],
            t_new=sim_data.cam_t[..., i].expand(B),
            obs_id=sim_data.obs_id[..., i, :].expand(B, -1),
            obs_uv=sim_data.obs_uv[:, i],
            obs_plane=sim_data.obs_plane[..., i, :].expand(B, -1),
        )
        state, bank, out = step(eng, state, bank, frame)
        outs.append(out)
    stacked = StepOutput(*(torch.stack(f, dim=1) for f in zip(*outs)))
    return state, bank, stacked
