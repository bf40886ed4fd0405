"""SLAM landmarks of B streams: delayed init, update, marginalization, re-anchoring.

Counterpart of ``ov_plane_tpu/models/slam.py`` (``UpdaterSLAM``,
update/UpdaterSLAM.cpp) on the static layout, with a leading stream
dimension:

* :func:`slam_delayed_init` (:66-374): up to ``max_init_per_frame``
  promoted tracks per frame, one after the other (each depends on the last
  through the free slot and the covariance) as a static Python loop of
  ``torch.where`` selects, after one batched triangulation of all of them:
  QR-split the stacked system on the landmark columns, χ²-gate the leftover
  rows, write the landmark into the first free slot (initialize_invertible)
  and apply the leftover rows as an EKF update. Point-on-plane rows join when the feature's plane is in the
  state and ``use_plane_constraint_slamd`` is set.
* :func:`slam_update` (:376-682): every tracked landmark's newest
  observation (two reprojection rows, plus a plane row), a per-landmark χ²
  gate with the reference's "drop the plane row and retry" (:547-610), one
  QR-compressed EKF update per stream.
* :func:`marginalize_lost_slam`: landmarks without a track leave the state
  (StateHelper::marginalize_slam, StateHelper.cpp:638-652).
* :func:`change_anchors` (:684-850): anchored landmarks whose anchor clone
  is about to be marginalized move to the newest clone.

Every per-stream choice is a select and every index is clamped in range, so
no step synchronizes with the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ov_plane_tpu_torch.models import feature_bank as fb
from ov_plane_tpu_torch.models.jacobians import (
    JacobianOptions,
    anchor_frames,
    clone_set_from_state,
    feature_jacobian_full,
    safe_anchor_point,
)
from ov_plane_tpu_torch.models.msckf import chi2_table
from ov_plane_tpu_torch.ops import ekf
from ov_plane_tpu_torch.ops import representations as reps
from ov_plane_tpu_torch.ops.triangulation import TriangulationOptions, triangulate
from ov_plane_tpu_torch.state.vio_state import VioState, tree_where


class SlamOptions(NamedTuple):
    jac: JacobianOptions = JacobianOptions()
    tri: TriangulationOptions = TriangulationOptions()
    sigma_px: float = 1.0
    chi2_multipler: float = 5.0
    sigma_c: float = 0.05
    use_plane_constraint_slamu: bool = False
    use_plane_constraint_slamd: bool = False
    max_init_per_frame: int = 8


def _slam_point_global(state: VioState, rep: int):
    """(p_FinG, p_FinG_fej) [B, L, 3] of every landmark slot from its stored
    representation parameters (Landmark::get_xyz)."""
    if rep == reps.GLOBAL_3D:
        return state.slam_p, state.slam_p_fej
    if not reps.is_anchored(rep):
        return reps.point_from_params(rep, state.slam_p), reps.point_from_params(rep, state.slam_p_fej)
    slot = state.slam_anchor_slot.to(torch.int64).clamp(0, state.layout.max_clones - 1)
    anc, anc_fej = anchor_frames(clone_set_from_state(state), slot)
    return (anc.point_to_global(reps.point_from_params(rep, state.slam_p)),
            anc_fej.point_to_global(reps.point_from_params(rep, state.slam_p_fej)))


def _plane_lookup(state: VioState, planeid: torch.Tensor):
    """Frontend plane ids [B, N] -> (in_state, slot, cp, cp_fej) of the planes in the state."""
    eq = (state.plane_id[:, None, :] == planeid[..., None]) & state.plane_active[:, None, :] & (planeid >= 0)[..., None]
    slot = fb.first_true(eq)
    return eq.any(dim=-1), slot, fb._take(state.plane_cp, slot), fb._take(state.plane_cp_fej, slot)


def _landmark_rows(state: VioState, bank: fb.FeatureBank):
    """(has_row, rows) [B, L]: whether a bank row carries each landmark's id, and the first such row."""
    eq = (state.slam_id[:, :, None] == bank.fid[:, None, :]) & (bank.fid >= 0)[:, None, :]   # [B, L, F]
    return eq.any(dim=-1), fb.first_true(eq)


def _gate(opts: SlamOptions, chi2: torch.Tensor, n_rows: torch.Tensor) -> torch.Tensor:
    table = chi2_table(chi2.dtype, chi2.device)
    dof = n_rows.clamp(min=1)
    return chi2 <= opts.chi2_multipler * table[dof.clamp(1, table.shape[0] - 1)]


def slam_delayed_init(state: VioState, bank: fb.FeatureBank, opts: SlamOptions, cand_idx: torch.Tensor,
                      cand_valid: torch.Tensor):
    """Initialize up to S new landmarks per stream from the bank rows
    cand_idx [B, S] (valid where cand_valid). Returns (state, bank, n_inited [B])."""
    lay = state.layout
    L = lay.max_slam
    F = bank.fid.shape[1]
    dtype, dev = state.imu.dtype, state.imu.device
    rep = opts.jac.rep
    clone_active = torch.isfinite(state.clones_t)
    # Every candidate triangulates against the clones of the frame's start
    # (as in the JAX scan) from its bank row, which the loop does not
    # change: one batched triangulation serves all of them.
    clones = clone_set_from_state(state)
    masks = fb._take(bank.mask, cand_idx) & clone_active[:, None] & cand_valid[..., None]   # [B, S, K]
    p_all, tri_all = triangulate(fb._take(bank.uvn, cand_idx), masks, clones.R_GtoC, clones.p_CinG, opts.tri)
    ones3 = torch.ones(3, dtype=dtype, device=dev)
    n_inited = torch.zeros(cand_idx.shape[0], dtype=torch.int64, device=dev)
    st, bk = state, bank
    for s in range(opts.max_init_per_frame):
        row = cand_idx[:, s:s + 1]                                           # [B, 1]
        uv, mask, p_f = fb._take(bk.uv, row), masks[:, s:s + 1], p_all[:, s:s + 1]   # [B, 1, ...]
        free = ~st.slam_active
        slot = fb.first_true(free)                                           # [B]
        valid = cand_valid[:, s] & free.any(dim=-1) & tri_all[:, s] & (mask.sum(dim=-1)[:, 0] >= 2)

        # Anchored reps anchor at the newest clone (ov_core: the feature's
        # last observation); the parameters of the triangulated point.
        cur = clone_set_from_state(st)
        anchor = st.newest_clone_slot
        kw = {}
        if rep == reps.GLOBAL_3D:
            params0 = p_f[:, 0]
        elif not reps.is_anchored(rep):
            params0 = reps.params_from_point(rep, p_f[:, 0])
        else:
            anc0, _ = anchor_frames(cur, anchor[:, None])
            p_A, a_ok = safe_anchor_point(anc0.point_to_anchor(p_f))
            params0 = reps.params_from_point(rep, p_A)[:, 0]
            valid = valid & a_ok[:, 0]
        if rep != reps.GLOBAL_3D:
            kw["anchor_slot"] = anchor[:, None]
        if opts.use_plane_constraint_slamd:
            planeid = bk.planeid.gather(1, row)
            in_state, pslot, cp, cp_fej = _plane_lookup(st, planeid)
            kw.update(cp=cp, cp_fej=cp_fej, has_plane=in_state, plane_in_state=in_state, plane_slot=pslot,
                      sigma_c=opts.sigma_c)
        H_x, H_f, res, rmask = (x[:, 0] for x in feature_jacobian_full(
            lay, opts.jac, cur, uv, mask, p_f, p_f, opts.sigma_px, **kw))
        vf = valid.to(dtype)
        H_x, H_f, res = H_x * vf[:, None, None], H_f * vf[:, None, None], res * vf[:, None]
        rmask = rmask & valid[:, None]

        HL_i, HR_i, res_i, HR_u, res_u = ekf.qr_init_split(H_f[..., 0:3], H_x, res)
        # χ² of the leftover rows (StateHelper::initialize, :463-475); H_L invertible.
        chi2 = ekf.innovation_chi2(st.cov, HR_u, res_u, torch.ones_like(res_u))
        diag_ok = (torch.diagonal(HL_i, dim1=-2, dim2=-1).abs() > 1e-8).all(dim=-1)
        do_init = valid & _gate(opts, chi2, rmask.sum(dim=-1)) & diag_ok

        new_cov, dx_new = ekf.initialize_invertible(st, lay.slam_base + 3 * slot, HR_i, HL_i, ones3, res_i)
        p_init = params0 + dx_new                     # dx_new lives in the representation's error space
        oh = fb._slot_onehot(slot, L)                 # [B, L]
        fid = bk.fid.gather(1, row)
        st_new = st.replace(
            cov=new_cov,
            slam_p=torch.where(oh[..., None], p_init[:, None], st.slam_p),
            slam_p_fej=torch.where(oh[..., None], p_init[:, None], st.slam_p_fej),
            slam_id=torch.where(oh, fid, st.slam_id),
            slam_active=st.slam_active | oh,
            slam_anchor_slot=torch.where(oh, anchor[:, None].to(torch.int32) if reps.is_anchored(rep) else -1,
                                         st.slam_anchor_slot),
        )
        st_upd, _ = ekf.ekf_update(st_new, HR_u, res_u, torch.ones_like(res_u))     # the leftover rows
        st = tree_where(do_init, st_upd, st)
        roh = fb._slot_onehot(row[:, 0], F)
        bk = tree_where(do_init, bk.replace(is_slam=bk.is_slam | roh,
                                            slam_slot=torch.where(roh, slot[:, None].to(torch.int32), bk.slam_slot)),
                        bk)
        n_inited = n_inited + do_init.to(torch.int64)
    return st, bk, n_inited


def slam_update(state: VioState, bank: fb.FeatureBank, opts: SlamOptions, cur_slot: torch.Tensor):
    """One stacked update of every tracked landmark with its newest
    observation (at clone slot cur_slot [B]). Returns (state, n_updated [B])."""
    lay = state.layout
    L, K, D = lay.max_slam, lay.max_clones, lay.dim
    B = state.imu.shape[0]
    dtype, dev = state.imu.dtype, state.imu.device
    rep = opts.jac.rep
    has_row, rows = _landmark_rows(state, bank)
    cur = fb._slot_onehot(cur_slot, K)                                        # [B, K]
    seen_now = (fb._take(bank.mask, rows) & cur[:, None]).any(dim=-1) & has_row
    tracked = state.slam_active & has_row & seen_now
    obs_mask = cur[:, None] & tracked[..., None]                              # [B, L, K]: the newest observation only
    p_l, p_l_fej = _slam_point_global(state, rep)
    kw = {}
    if rep != reps.GLOBAL_3D:
        kw["anchor_slot"] = state.slam_anchor_slot.to(torch.int64).clamp(0, K - 1)
    if opts.use_plane_constraint_slamu:
        in_state, pslot, cp, cp_fej = _plane_lookup(state, bank.planeid.gather(1, rows))
        kw.update(cp=cp, cp_fej=cp_fej, has_plane=in_state, plane_in_state=in_state, plane_slot=pslot,
                  sigma_c=opts.sigma_c)
    H_x, H_f, res, rmask = feature_jacobian_full(lay, opts.jac, clone_set_from_state(state),
                                                 fb._take(bank.uv, rows), obs_mask, p_l, p_l_fej, opts.sigma_px, **kw)
    # The landmark's own columns take H_f's point part.
    eyeL = torch.eye(L, dtype=dtype, device=dev)
    blk = torch.einsum("blrc,lm->blrmc", H_f[..., 0:3], eyeL).reshape(B, L, 3 * K, 3 * L)
    H_x[..., lay.slam_base:lay.slam_base + 3 * L] = H_x[..., lay.slam_base:lay.slam_base + 3 * L] + blk

    def gate(h, r, rm):
        return _gate(opts, ekf.innovation_chi2(state.cov[:, None], h, r, torch.ones_like(r)), rm.sum(dim=-1))

    ok_full = gate(H_x, res, rmask)
    take_full = ok_full & tracked
    H_use = torch.where(take_full[..., None, None], H_x, 0.0)
    res_use = torch.where(take_full[..., None], res, 0.0)
    taken = take_full
    if opts.use_plane_constraint_slamu:
        # Plane-drop fallback: without the plane rows (rows 2K:), gated again.
        keep = torch.arange(3 * K, device=dev) < 2 * K
        H_nop, res_nop = H_x * keep[:, None], res * keep
        take_nop = ~ok_full & gate(H_nop, res_nop, rmask & keep) & tracked
        H_use = torch.where(take_nop[..., None, None], H_nop, H_use)
        res_use = torch.where(take_nop[..., None], res_nop, res_use)
        taken = take_full | take_nop
    H_c, r_c = ekf.measurement_compress(H_use.reshape(B, L * 3 * K, D), res_use.reshape(B, L * 3 * K))
    dx, new_cov, _ = ekf.kalman_update(state.cov, H_c, r_c, torch.ones(H_c.shape[-2], dtype=dtype, device=dev))
    new_state = ekf.apply_dx(state.replace(cov=new_cov), dx)
    return tree_where(taken.any(dim=-1), new_state, state), taken.sum(dim=-1)


def marginalize_lost_slam(state: VioState, bank: fb.FeatureBank):
    """Marginalize the landmarks whose track is gone (no bank row carries
    their id). Returns (state, n_lost [B])."""
    lay = state.layout
    L = lay.max_slam
    has_row, _ = _landmark_rows(state, bank)
    lost = state.slam_active & ~has_row
    j = torch.arange(lay.dim, device=lost.device)
    in_slam = (j >= lay.slam_base) & (j < lay.slam_base + 3 * L)
    lost_col = lost.gather(1, ((j - lay.slam_base) // 3).clamp(0, L - 1).expand(lost.shape[0], -1)) & in_slam
    keep = (~lost_col).to(state.cov.dtype)
    return state.replace(
        cov=state.cov * keep[:, None, :] * keep[:, :, None],
        slam_active=state.slam_active & ~lost,
        slam_id=torch.where(lost, -1, state.slam_id),
        slam_anchor_slot=torch.where(lost, -1, state.slam_anchor_slot),
    ), lost.sum(dim=-1)


def change_anchors(state: VioState, rep: int, do_fej: bool, marg_slot: torch.Tensor, new_slot: torch.Tensor):
    """Re-anchor the landmarks anchored at clone marg_slot [B] (about to be
    marginalized) at clone new_slot [B] (UpdaterSLAM::change_anchors).

    The parameters are re-expressed in the new anchor frame, and the
    covariance is transformed with the exact error-state Jacobian of the
    re-anchoring: from the invariance of the global point,
    δf_new = Hf_new⁻¹ (Hf_old δf_old + Ha_old δa_old − Ha_new δa_new), one
    sandwich P ← E P Eᵀ with E = I but the affected landmarks' rows.
    Returns (state, n_changed [B])."""
    lay = state.layout
    L, D = lay.max_slam, lay.dim
    B = state.imu.shape[0]
    dtype, dev = state.imu.dtype, state.imu.device
    need = state.slam_active & (state.slam_anchor_slot == marg_slot[:, None])
    clones = clone_set_from_state(state)
    anc_old, anc_old_fej = anchor_frames(clones, marg_slot[:, None].expand(B, L))
    anc_new, anc_new_fej = anchor_frames(clones, new_slot[:, None].expand(B, L))

    p_G, p_G_fej = _slam_point_global(state, rep)
    p_A, ok1 = safe_anchor_point(anc_new.point_to_anchor(p_G))
    p_A_fej, ok2 = safe_anchor_point(anc_new_fej.point_to_anchor(p_G_fej))
    new_p, new_pf = reps.params_from_point(rep, p_A), reps.params_from_point(rep, p_A_fej)
    rj_old = reps.rep_jacobians(rep, p_G, p_G_fej, anc_old, anc_old_fej, fej=do_fej)
    rj_new = reps.rep_jacobians(rep, p_G, p_G_fej, anc_new, anc_new_fej, fej=do_fej)
    Hf_new_inv = ekf.inv3(rj_new.H_f, eps=1e-18)   # the JAX module's determinant guard
    Jl = Hf_new_inv @ rj_old.H_f              # [B, L, 3, 3] d f_new / d f_old
    Jao = Hf_new_inv @ rj_old.H_anchor        # [B, L, 3, 6] d f_new / d a_old
    Jan = -Hf_new_inv @ rj_new.H_anchor       # [B, L, 3, 6] d f_new / d a_new
    finite = lambda x: torch.isfinite(x).flatten(-2).all(dim=-1)  # noqa: E731
    do = need & ok1 & ok2 & finite(Jl) & finite(Jao) & finite(Jan)

    # The affected landmarks' rows of E: Jl at their own columns, Jao at the
    # old anchor's and Jan at the new anchor's (Jan wins where they coincide).
    j = torch.arange(D, device=dev)
    k = torch.arange(6, device=dev)
    col_old = (lay.clone_base + 6 * marg_slot)[:, None, None] + k[None, :, None] == j       # [B, 6, D]
    col_new = (lay.clone_base + 6 * new_slot)[:, None, None] + k[None, :, None] == j
    rows = torch.where(col_new.any(dim=1)[:, None, None, :], Jan @ col_new.to(dtype)[:, None],
                       Jao @ col_old.to(dtype)[:, None])                                       # [B, L, 3, D]
    eyeL = torch.eye(L, dtype=dtype, device=dev)
    rows[..., lay.slam_base:lay.slam_base + 3 * L] = torch.einsum("blij,lm->blimj", Jl, eyeL).reshape(B, L, 3, 3 * L)
    eye_rows = torch.eye(D, dtype=dtype, device=dev)[lay.slam_base:lay.slam_base + 3 * L].reshape(L, 3, D)
    rows = torch.where(do[..., None, None], rows, eye_rows)
    E = torch.eye(D, dtype=dtype, device=dev).repeat(B, 1, 1)
    E[:, lay.slam_base:lay.slam_base + 3 * L] = rows.reshape(B, 3 * L, D)
    cov_new = E @ state.cov @ E.transpose(-1, -2)
    cov_new = 0.5 * (cov_new + cov_new.transpose(-1, -2))
    return state.replace(
        cov=torch.where(do.any(dim=-1)[:, None, None], cov_new, state.cov),
        slam_p=torch.where(do[..., None], new_p, state.slam_p),
        slam_p_fej=torch.where(do[..., None], new_pf, state.slam_p_fej),
        slam_anchor_slot=torch.where(do, new_slot[:, None].to(torch.int32), state.slam_anchor_slot),
    ), do.sum(dim=-1)
