"""VIO engine of B streams: the per-frame filter step and sequence replay.

Counterpart of ``ov_plane_tpu/models/manager.py`` for the MSCKF path with
SLAM landmarks and CP planes (ZUPT, ArUco, ground-truth injection and
calibration come with later slices of the port and raise here). One frame is

    propagate + clone → undistort + ingest → triage (MSCKF selection, SLAM
    promotion) → [marginalize lost landmarks] → [plane merges, unseen-plane
    marginalization, delayed plane init → grouped plane MSCKF update → NaN
    firewall] → MSCKF update (point-on-plane rows for planes in the state)
    → [SLAM update → SLAM delayed init] → [re-anchor the landmarks anchored
    at the oldest clone] → free consumed tracks → marginalize the oldest clone

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
from ov_plane_tpu_torch.models.plane_init import (
    PlaneInitOptions,
    marginalize_unseen_planes,
    merge_planes,
    plane_delayed_init,
)
from ov_plane_tpu_torch.models.plane_msckf import PlaneMsckfOptions, msckf_plane_update
from ov_plane_tpu_torch.models.slam import (
    SlamOptions,
    change_anchors,
    marginalize_lost_slam,
    slam_delayed_init,
    slam_update,
)
from ov_plane_tpu_torch.ops import cams
from ov_plane_tpu_torch.ops import representations as reps
from ov_plane_tpu_torch.ops.planefit import PlaneRefineOptions
from ov_plane_tpu_torch.ops.triangulation import TriangulationOptions
from ov_plane_tpu_torch.state.layout import StateLayout
from ov_plane_tpu_torch.state.propagator import PropagatorOptions, marginalize_oldest_clone, propagate_and_clone
from ov_plane_tpu_torch.state.vio_state import VioState, tree_where
from ov_plane_tpu_torch.utils.config import VioConfig
from ov_plane_tpu_torch.utils.torchenv import resolve_device


# Profiler ranges of the step's stages (torch.profiler.record_function), in order.
STAGES = ("step.propagate_and_clone", "step.ingest", "step.triage", "step.slam_marginalize", "step.plane_init",
          "step.plane_msckf", "step.msckf_update", "step.slam_update", "step.slam_init", "step.slam_anchor",
          "step.marginalize")


class FrameData(NamedTuple):
    """One camera frame of every stream."""

    imu_t: torch.Tensor      # [B, I] IMU window covering [state.t, t_new]
    imu_w: torch.Tensor      # [B, I, 3]
    imu_a: torch.Tensor      # [B, I, 3]
    t_new: torch.Tensor      # [B]
    obs_id: torch.Tensor     # [B, O] int (-1 pad)
    obs_uv: torch.Tensor     # [B, O, 2]
    obs_plane: torch.Tensor  # [B, O] int
    # Frontend plane-id merges of this frame, "old id merge_from[q] is now
    # merge_into[q]" (VioManager.cpp:516-533); None = no merges.
    merge_from: torch.Tensor | None = None  # [B, Q] int (-1 pad)
    merge_into: torch.Tensor | None = None  # [B, Q] int


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
    n_slam: torch.Tensor              # [B] SLAM landmarks in the state
    n_slam_init: torch.Tensor         # [B] landmarks initialized this frame
    n_slam_update: torch.Tensor       # [B] landmarks updated this frame (not in the JAX StepOutput)
    n_planes: torch.Tensor            # [B] plane states alive
    n_plane_init: torch.Tensor        # [B] delayed inits (not masked by the delay gate, as in JAX)
    n_plane_constraints: torch.Tensor  # [B] features updated under a point-on-plane constraint
    n_plane_merges: torch.Tensor      # [B] in-state plane pairs merged
    n_plane_dropped: torch.Tensor     # [B] qualifying plane groups beyond the per-frame cap
    cov_ori_blk: torch.Tensor   # [B, 3, 3]
    cov_pos_blk: torch.Tensor


@dataclass(frozen=True)
class VioEngine:
    """Static engine parameters derived from VioConfig."""

    layout: StateLayout
    prop_opts: PropagatorOptions
    msckf_opts: MsckfOptions
    slam_opts: SlamOptions
    plane_opts: PlaneInitOptions
    plane_msckf_opts: PlaneMsckfOptions
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
    max_slam: int
    dt_slam_delay: float
    use_planes: bool
    sigma_plane_merge: float
    plane_merge_chi2: float
    plane_merge_deg_max: float
    device: torch.device

    @property
    def use_slam(self) -> bool:
        return self.max_slam > 0

    @classmethod
    def from_config(cls, cfg: VioConfig, device="cuda") -> "VioEngine":
        st = cfg.state
        rep_msckf, rep_slam = reps.from_name(st.feat_rep_msckf), reps.from_name(st.feat_rep_slam)
        if st.use_plane_constraint and (rep_msckf != reps.GLOBAL_3D or rep_slam != reps.GLOBAL_3D):
            raise ValueError("feat_rep_msckf and feat_rep_slam must be GLOBAL_3D when plane constraints are "
                             "on (the reference asserts this, VioManager.cpp:823,839)")
        if reps.ANCHORED_INVERSE_DEPTH_SINGLE in (rep_msckf, rep_slam):
            raise NotImplementedError("ANCHORED_INVERSE_DEPTH_SINGLE is 1-dof and does not fit the fixed "
                                      "3-column feature and landmark layout (as in the JAX package); "
                                      "use a 3-dof representation")
        later = {
            "plane RANSAC (use_plane_ransac)": st.use_plane_ransac,
            "ZUPT (try_zupt)": cfg.try_zupt,
            "ArUco landmarks (use_aruco)": cfg.use_aruco,
            "ground-truth injection (use_groundtruths)": st.use_groundtruths,
            "sharded compression (tpu.shard_axis)": bool(cfg.tpu.shard_axis),
            "online calibration (do_calib_camera_*)": (
                st.do_calib_camera_pose or st.do_calib_camera_intrinsics or st.do_calib_camera_timeoffset),
        }
        for what, on in later.items():
            if on:
                raise NotImplementedError(f"{what} is not ported yet: it comes with a later slice "
                                          "of ov_plane_tpu_torch (see ROADMAP.md queue 1)")
        lay = StateLayout(
            max_clones=st.max_clone_size + 1,  # +1: transient slot between clone and marginalize
            max_slam=max(st.max_slam_features, 1), max_planes=cfg.tpu.max_planes,
            calib_dt=False, calib_pose=False, calib_intr=False,
        )
        tri = TriangulationOptions(
            min_dist=cfg.featinit.min_dist, max_dist=cfg.featinit.max_dist,
            max_cond=cfg.featinit.max_cond_number, refine=cfg.featinit.refine_features,
            max_runs=cfg.featinit.max_runs,
        )
        cam_model = cams.RADTAN if cfg.cam_model == "radtan" else cams.EQUI
        jac = JacobianOptions(cam_model=cam_model, do_fej=st.do_fej)
        po = PlaneInitOptions(
            jac=jac, tri=tri,
            refine=PlaneRefineOptions(
                sigma_px=cfg.msckf_options.sigma_pix, sigma_c=st.sigma_constraint,
                cauchy_scale=st.plane_refine_cauchy, max_error_threshold=st.plane_refine_max_error,
                min_inlier_ratio=st.plane_refine_min_inlier_ratio,
                # The refine's residuals are normalized coordinates: whitened by focal/σ_px.
                focal=float(0.5 * (cfg.cam_intrinsics[0] + cfg.cam_intrinsics[1]))),
            sigma_px=cfg.msckf_options.sigma_pix, sigma_c=st.sigma_constraint,
            const_init_multi=st.const_init_multi, const_init_chi2=st.const_init_chi2,
            plane_init_min_feat=st.plane_init_min_feat, plane_init_max_cond=st.plane_init_max_cond,
            max_msckf_plane=st.max_msckf_plane, use_refine_plane_feat=st.use_refine_plane_feat,
            use_info_compression=cfg.tpu.use_info_compression, sigma_c_adaptive=cfg.tpu.sigma_c_adaptive,
        )
        return cls(
            layout=lay,
            prop_opts=PropagatorOptions(use_rk4=st.use_rk4_integration, imu_avg=st.imu_avg,
                                        do_fej=st.do_fej),
            msckf_opts=MsckfOptions(
                jac=jac._replace(rep=rep_msckf), tri=tri,
                sigma_px=cfg.msckf_options.sigma_pix,
                chi2_multipler=cfg.msckf_options.chi2_multipler,
                sigma_c=st.sigma_constraint,
                use_plane_constraint=st.use_plane_constraint and st.use_plane_constraint_msckf,
                use_info_compression=cfg.tpu.use_info_compression,
            ),
            slam_opts=SlamOptions(
                jac=jac._replace(rep=rep_slam), tri=tri,
                sigma_px=cfg.slam_options.sigma_pix, chi2_multipler=cfg.slam_options.chi2_multipler,
                sigma_c=st.sigma_constraint,
                use_plane_constraint_slamu=st.use_plane_constraint and st.use_plane_constraint_slamu,
                use_plane_constraint_slamd=st.use_plane_constraint and st.use_plane_constraint_slamd,
                max_init_per_frame=8,
            ),
            plane_opts=po,
            plane_msckf_opts=PlaneMsckfOptions(
                base=po, chi2_multipler=cfg.msckf_options.chi2_multipler,
                plane_msckf_min_feat=st.plane_msckf_min_feat, plane_msckf_max_cond=st.plane_msckf_max_cond,
                max_planes_per_frame=cfg.tpu.max_planes_per_frame,
            ),
            cam_model=cam_model,
            max_clone_size=st.max_clone_size,
            max_msckf_in_update=st.max_msckf_in_update,
            max_msckf_batch=max(cfg.tpu.max_msckf_update, st.max_msckf_in_update),
            gravity_mag=cfg.gravity_mag,
            sigma_w2=cfg.imu_noises.sigma_w_2, sigma_a2=cfg.imu_noises.sigma_a_2,
            sigma_wb2=cfg.imu_noises.sigma_wb_2, sigma_ab2=cfg.imu_noises.sigma_ab_2,
            min_clones_to_update=min(st.max_clone_size, 5),
            max_slam=st.max_slam_features,
            dt_slam_delay=2.0,
            use_planes=st.use_plane_constraint and st.use_plane_slam_feats,
            sigma_plane_merge=st.sigma_plane_merge, plane_merge_chi2=st.plane_merge_chi2,
            plane_merge_deg_max=st.plane_merge_deg_max,
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


def triage(eng: VioEngine, state: VioState, bank: fb.FeatureBank, cur_slot: torch.Tensor,
           allow_slam: torch.Tensor):
    """Feature triage (VioManager.cpp:375-506). SLAM promotion: the tracks
    that span the whole window at the marginalization boundary, the longest
    first, up to the free landmark capacity, where ``allow_slam`` [B]. MSCKF
    selection: the top max_msckf_in_update of (lost ∪ marg) without the
    promoted tracks, by track length, padded to the static batch M.
    Returns (sel_idx [B, M], sel_valid [B, M], slam_idx [B, S],
    slam_valid [B, S]); with SLAM off, S = 0."""
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
    slam_idx = torch.zeros(B, 0, dtype=torch.int64, device=nobs.device)
    slam_valid = torch.zeros(B, 0, dtype=torch.bool, device=nobs.device)
    if eng.use_slam:
        S = eng.slam_opts.max_init_per_frame
        free_cap = eng.max_slam - state.slam_active.sum(dim=-1)
        maxtrack = marg & (nobs > eng.max_clone_size) & allow_slam[:, None]
        s_scores, slam_idx = fb.topk_first_index(torch.where(maxtrack, nobs, -1), S)
        slam_valid = (s_scores > 0) & (torch.arange(S, device=nobs.device) < free_cap[:, None])
        promoted = ((torch.arange(F, device=nobs.device)[None, :, None] == slam_idx[:, None, :])
                    & slam_valid[:, None, :]).any(dim=-1)
        candidates = candidates & ~promoted
    score = torch.where(candidates, nobs, -1)
    k = min(M, F)
    top_scores, sel_idx = fb.topk_first_index(score, k)
    if k < M:
        top_scores = torch.cat([top_scores, top_scores.new_full((B, M - k), -1)], dim=1)
        sel_idx = torch.cat([sel_idx, sel_idx.new_zeros((B, M - k))], dim=1)
    rank_ok = torch.arange(M, device=score.device) < eng.max_msckf_in_update
    return sel_idx, (top_scores >= 2) & rank_ok, slam_idx, slam_valid


@functools.lru_cache(maxsize=16)
def _imu_constants(eng: VioEngine, dtype: torch.dtype, device: torch.device):
    """(noises [σ_w², σ_a², σ_wb², σ_ab²], gravity) on the device, made once:
    a host-to-device copy inside the step would synchronize the stream."""
    noises = torch.tensor([eng.sigma_w2, eng.sigma_a2, eng.sigma_wb2, eng.sigma_ab2], dtype=dtype, device=device)
    return noises, torch.tensor([0.0, 0.0, eng.gravity_mag], dtype=dtype, device=device)


def step(eng: VioEngine, state: VioState, bank: fb.FeatureBank, frame: FrameData):
    """One camera frame of every stream (do_feature_propagate_update,
    VioManager.cpp:330-986, without ZUPT). Returns (state, bank, StepOutput)."""
    if state.cov.device != eng.device:
        raise ValueError(f"state lies on {state.cov.device}, the engine on {eng.device}")
    dev = state.imu.device
    B = state.imu.shape[0]
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
        past_delay = (state.t - state.startup_t) >= eng.dt_slam_delay
        sel_idx, sel_valid, slam_idx, slam_valid = triage(eng, state, bank, new_slot, can_update & past_delay)
        sel_valid = sel_valid & can_update[:, None]
        slam_valid = slam_valid & can_update[:, None]

    zero = torch.zeros(B, dtype=torch.int64, device=dev)
    n_slam_init = n_slam_update = zero
    if eng.use_slam:
        # 4. Landmarks whose track is gone leave the state.
        with record_function("step.slam_marginalize"):
            state, _ = marginalize_lost_slam(state, bank)

    n_plane_init = n_plane_merges = n_plane_constraints = n_plane_dropped = zero
    sel_valid_main = sel_valid
    if eng.use_planes:
        state_preplane, bank_preplane = state, bank
        gate = can_update & past_delay
        # 5. Frontend merges first (VioManager.cpp:516-533), then the unseen
        #    planes leave the state, then the delayed init.
        with record_function("step.plane_init"):
            if frame.merge_from is not None:
                state, n_plane_merges = merge_planes(state, frame.merge_from, frame.merge_into,
                                                     eng.sigma_plane_merge, eng.plane_merge_chi2,
                                                     eng.plane_merge_deg_max)
                # Relabel bank features still carrying a merged-away id.
                pid = bank.planeid
                for q in range(frame.merge_from.shape[1]):
                    f, g = frame.merge_from[:, q:q + 1], frame.merge_into[:, q:q + 1]
                    pid = torch.where((pid == f) & (f >= 0) & (g >= 0), g.to(pid.dtype), pid)
                bank = bank.replace(planeid=pid)
            marged, _ = marginalize_unseen_planes(state, bank, new_slot)
            state = tree_where(gate, marged, state)
            init_state, init_bank, n_plane_init = plane_delayed_init(state, bank, eng.plane_opts, new_slot)
            state = tree_where(gate, init_state, state)
            bank = tree_where(gate, init_bank, bank)

        # 6a. Grouped MSCKF-plane updates of out-of-state planes (they consume
        #     their features).
        with record_function("step.plane_msckf"):
            if eng.msckf_opts.use_plane_constraint:
                pl_state, consumed_sel, _, n_pm_drop = msckf_plane_update(state, bank, eng.plane_msckf_opts,
                                                                          sel_idx, sel_valid)
                state = tree_where(gate, pl_state, state)
                consumed_sel = consumed_sel & gate[:, None]
                sel_valid_main = sel_valid & ~consumed_sel
                n_plane_constraints = consumed_sel.sum(dim=-1)
                n_plane_dropped = torch.where(gate, n_pm_drop, 0)

            # NaN firewall: a non-finite state after the plane stages reverts
            # them for the frame (the classic update runs on the pre-plane
            # state). n_plane_dropped stays as counted, as in JAX.
            plane_finite = (torch.isfinite(state.cov).flatten(1).all(dim=-1)
                            & torch.isfinite(state.imu).all(dim=-1)
                            & torch.isfinite(torch.where(state.plane_active[..., None], state.plane_cp, 0.0))
                            .flatten(1).all(dim=-1))
            state = tree_where(plane_finite, state, state_preplane)
            bank = tree_where(plane_finite, bank, bank_preplane)
            sel_valid_main = torch.where(plane_finite[:, None], sel_valid_main, sel_valid)
            n_plane_constraints = torch.where(plane_finite, n_plane_constraints, 0)
            n_plane_init = torch.where(plane_finite, n_plane_init, 0)
            n_plane_merges = torch.where(plane_finite, n_plane_merges, 0)

    # 6b. MSCKF update of the selected tracks (point-on-plane rows for the
    #     features whose plane is in the state).
    with record_function("step.msckf_update"):
        sel_mask = fb._take(bank.mask, sel_idx) & sel_valid_main[..., None]
        plane = {}
        if eng.msckf_opts.use_plane_constraint:
            sel_pid = bank.planeid.gather(1, sel_idx)
            peq = ((sel_pid[:, :, None] == state.plane_id[:, None, :]) & state.plane_active[:, None, :]
                   & (sel_pid >= 0)[:, :, None])                       # [B, M, P]
            p_in_state = peq.any(dim=-1)
            p_slot = fb.first_true(peq)
            sel_cp = fb._take(state.plane_cp, p_slot)
            plane = dict(sel_plane_cp=sel_cp, sel_plane_cp_fej=fb._take(state.plane_cp_fej, p_slot),
                         sel_has_plane=p_in_state, sel_plane_in_state=p_in_state, sel_plane_slot=p_slot)
        state, used, _, _ = msckf_update(state, eng.msckf_opts, fb._take(bank.uv, sel_idx),
                                         fb._take(bank.uvn, sel_idx), sel_mask, **plane)
        if eng.msckf_opts.use_plane_constraint:
            n_plane_constraints = n_plane_constraints + (used & plane["sel_has_plane"]).sum(dim=-1)

    if eng.use_slam:
        # 7. Landmark update with the newest observations, then 8. the
        #    delayed init of the promoted tracks.
        with record_function("step.slam_update"):
            upd_state, n_slam_update = slam_update(state, bank, eng.slam_opts, new_slot)
            state = tree_where(can_update, upd_state, state)
            n_slam_update = torch.where(can_update, n_slam_update, 0)
        with record_function("step.slam_init"):
            state, bank, n_slam_init = slam_delayed_init(state, bank, eng.slam_opts, slam_idx, slam_valid)

    marg_slot = state.oldest_clone_slot
    over = state.num_clones > eng.max_clone_size
    if eng.use_slam and reps.is_anchored(eng.slam_opts.jac.rep):
        # Landmarks anchored at the clone about to go re-anchor at the newest
        # one first (UpdaterSLAM::change_anchors, VioManager.cpp:855-869).
        with record_function("step.slam_anchor"):
            anch_state, _ = change_anchors(state, eng.slam_opts.jac.rep, eng.prop_opts.do_fej, marg_slot,
                                           state.newest_clone_slot)
            state = tree_where(over, anch_state, state)

    with record_function("step.marginalize"):
        # 9. Free the consumed rows (to_delete semantics).
        F = bank.fid.shape[1]
        consumed = ((torch.arange(F, device=dev)[None, :, None] == sel_idx[:, None, :])
                    & sel_valid[:, None, :]).any(dim=-1)
        bank = fb.free_rows(bank, consumed)

        # 10. Marginalize the oldest clone if over budget; clear its column.
        state = marginalize_oldest_clone(state, eng.max_clone_size)
        cleared = fb.clear_clone_column(bank, marg_slot)
        bank = tree_where(over, cleared, bank)
        state = state.replace(has_moved=torch.ones_like(state.has_moved))

    diag = torch.diagonal(state.cov, dim1=-2, dim2=-1)
    out = StepOutput(
        t=state.t, q=state.imu[:, 0:4], p=state.imu[:, 4:7], v=state.imu[:, 7:10],
        bg=state.imu[:, 10:13], ba=state.imu[:, 13:16], cov_diag_imu=diag[:, :15],
        n_msckf_used=(used & sel_valid).sum(dim=-1), n_clones=state.num_clones,
        n_bank=bank.active.sum(dim=-1), n_slam=state.slam_active.sum(dim=-1), n_slam_init=n_slam_init,
        n_slam_update=n_slam_update, n_planes=state.plane_active.sum(dim=-1),
        n_plane_init=n_plane_init, n_plane_constraints=n_plane_constraints,
        n_plane_merges=n_plane_merges, n_plane_dropped=n_plane_dropped,
        cov_ori_blk=state.cov[:, 0:3, 0:3], cov_pos_blk=state.cov[:, 3:6, 3:6],
    )
    return state, bank, out


def run_sequence(eng: VioEngine, state: VioState, bank: fb.FeatureBank, sim_data, imu_window: int,
                 n_frames: int | None = None, start: int = 1):
    """Replay a simulated sequence of B streams (``sim.simulator.SimData``).

    Frame 0 is the initialization frame; frames start..start+n_frames−1 are
    stepped (all of them from frame 1 by default; a later ``start`` continues
    a state that was stepped up to frame start−1). Returns (state, bank,
    outputs) with every output stacked to [B, T, ...].
    """
    total = sim_data.cam_t.shape[-1]
    n_frames = total - start if n_frames is None else n_frames
    B = state.imu.shape[0]
    Ti = sim_data.imu_t.shape[-1]
    # The window starts are scene constants kept on the host; a start past
    # the end is clamped as lax.dynamic_slice clamps it.
    starts = np.asarray(sim_data.imu_window_start)
    outs = []
    for i in range(start, start + n_frames):
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
