"""Delayed CP-plane initialization into the state, and plane bookkeeping.

Counterpart of ``ov_plane_tpu/models/plane_init.py`` for B streams
(UpdaterPlane::init_vio_plane and the plane half of
StateHelper::merge_planes_and_marginalize):

* :func:`plane_delayed_init` — candidate planes are the distinct frontend
  plane ids among eligible bank features, ranked by support; each of the two
  best (one after the other: each conditions the next) gathers its best
  ``max_msckf_plane`` features → triangulation → LSQ plane fit with a
  condition gate → joint refine → stacked Jacobians with the CP columns kept
  → per-feature nullspace projection of the point columns → compression →
  QR split on the CP columns → χ² gate → ``initialize_invertible`` into a
  free plane slot + the leftover update. Features of a successful init are
  freed. With ``use_ransac`` the triangulated support first passes a plane
  RANSAC (``ops/planefit.plane_ransac``) whose draws :func:`ransac_draws`
  makes from (8888, plane id).
* :func:`merge_planes` — frontend plane-id merges: rename, or a gated
  3-row merge update and marginalization of the merged-away plane.
* :func:`marginalize_unseen_planes` — plane states without a supporting
  observation in the current frame leave the state.

Per-stream slots are one-hot selects over the P plane slots; every decision
is a ``torch.where``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ov_plane_tpu_torch.models import feature_bank as fb
from ov_plane_tpu_torch.models.feature_bank import first_true, topk_first_index
from ov_plane_tpu_torch.models.jacobians import JacobianOptions, clone_set_from_state, feature_jacobian_full
from ov_plane_tpu_torch.models.msckf import chi2_table
from ov_plane_tpu_torch.ops import ekf
from ov_plane_tpu_torch.ops.planefit import (
    PlaneRansacOptions,
    PlaneRefineOptions,
    fit_plane_lsq,
    plane_ransac,
    refine_plane_joint,
)
from ov_plane_tpu_torch.ops.triangulation import TriangulationOptions, triangulate
from ov_plane_tpu_torch.state.vio_state import VioState, tree_where


class PlaneInitOptions(NamedTuple):
    jac: JacobianOptions = JacobianOptions()
    tri: TriangulationOptions = TriangulationOptions()
    refine: PlaneRefineOptions = PlaneRefineOptions()
    sigma_px: float = 1.0
    sigma_c: float = 0.05
    const_init_multi: float = 5.0
    const_init_chi2: float = 1.0
    plane_init_min_feat: int = 10
    plane_init_max_cond: float = 50.0
    max_msckf_plane: int = 20
    max_inits_per_frame: int = 2
    use_refine_plane_feat: bool = True
    # RANSAC on the triangulated support before the fit (PlaneFitting::plane_fitting).
    use_ransac: bool = False
    ransac: PlaneRansacOptions = PlaneRansacOptions()
    use_info_compression: bool = False
    sigma_c_adaptive: bool = False


RANSAC_SEED = 8888


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (xorshift-multiply rounds) on int64 tensors
    holding values below 2**32; every product stays below 2**63."""
    m = 0xFFFFFFFF
    x = ((x >> 16) ^ x) * 0x45D9F3B & m
    x = ((x >> 16) ^ x) * 0x45D9F3B & m
    return (x >> 16) ^ x


def ransac_draws(plane: torch.Tensor, num_hyps: int, n: int, dtype: torch.dtype) -> torch.Tensor:
    """Uniform draws in [0, 1) for the RANSAC of plane ids [B]: [B, num_hyps, n].

    A counter-based hash of (RANSAC_SEED, plane id, hypothesis, point) made
    on the device: a candidate's draws depend on its plane id alone, as the
    JAX package's ``fold_in(PRNGKey(8888), plane)`` keys do (whose draws a
    torch generator cannot reproduce; the parity tests pass JAX's own), and
    no plane id is read on the host inside a step."""
    dev = plane.device
    key = _mix32((plane.to(torch.int64) & 0xFFFFFFFF) ^ RANSAC_SEED)[:, None, None]
    ctr = torch.arange(num_hyps * n, device=dev, dtype=torch.int64).reshape(1, num_hyps, n)
    bits = _mix32(_mix32(key ^ ctr) + 0x9E3779B9 & 0xFFFFFFFF)
    return ((bits >> 8).to(dtype)) * (1.0 / (1 << 24))


def distinct_candidates(pid: torch.Tensor):
    """Per row of pid [..., N] (−1 = none): (count [..., N] of equal ids, is
    the first row of its id [..., N])."""
    N = pid.shape[-1]
    eq = (pid[..., :, None] == pid[..., None, :]) & (pid >= 0)[..., :, None]
    count = eq.sum(dim=-1)
    lower = torch.tril(torch.ones(N, N, dtype=torch.bool, device=pid.device), diagonal=-1)
    return count, ~(eq & lower).any(dim=-1) & (pid >= 0)


def adaptive_sigma_c(cp, fvalid, p_tri, p_f, sigma_c: float):
    """Tilt-aware constraint sigma of a plane group: sqrt(σc² + σ_z² +
    (‖cp‖·σ_z/s_lat)²), σ_z the pre-refine point-to-plane scatter and s_lat
    the lateral spread of the support. cp [..., 3], fvalid [..., N],
    p_tri / p_f [..., N, 3]. Returns [...]."""
    d_pl = torch.clamp(torch.linalg.vector_norm(cp, dim=-1), min=1e-9)
    n_pl = cp / d_pl[..., None]
    fv = fvalid.to(cp.dtype)
    F_n = torch.clamp(fv.sum(dim=-1), min=1.0)
    r_pp = (torch.sum(p_tri * n_pl[..., None, :], dim=-1) - d_pl[..., None]) * fv
    s2_z = torch.sum(r_pp**2, dim=-1) / F_n
    c_lat = torch.sum(p_f * fv[..., None], dim=-2) / F_n[..., None]
    rel = (p_f - c_lat[..., None, :]) * fv[..., None]
    lat = rel - torch.sum(rel * n_pl[..., None, :], dim=-1)[..., None] * n_pl[..., None, :]
    s2_lat = torch.clamp(torch.sum(lat**2, dim=(-1, -2)) / F_n, min=1e-6)
    tilt = d_pl * torch.sqrt(s2_z / s2_lat)
    return torch.sqrt(sigma_c**2 + s2_z + tilt**2)


def project_plane_features(lay, opts: PlaneInitOptions, clones, uv, masks, p_f, fvalid, cp, sigma_c, valid=None):
    """Stacked systems of the plane's support with the CP in H_f[..., 3:6],
    the point columns nullspace-projected away per feature.

    uv [B, G, N, K, 2], masks [B, G, N, K], p_f [B, G, N, 3], fvalid
    [B, G, N], cp [B, G, 3], sigma_c a float or [B, G]; ``valid`` [B, G]
    zeroes whole groups. Returns (rows [B, G, N·(3K−3), 3+D+1] as
    [H_cp | H_x | res], n_rows [B, G]: the constraint and reprojection rows
    of the valid features)."""
    B, G, N, K = masks.shape
    D = lay.dim
    cp_f = cp[:, :, None, :].expand(B, G, N, 3).reshape(B, G * N, 3)
    sc = sigma_c if not isinstance(sigma_c, torch.Tensor) else sigma_c[:, :, None].expand(B, G, N).reshape(B, G * N)
    ones = torch.ones(B, G * N, dtype=torch.bool, device=masks.device)
    H_x, H_f, res, rmask = feature_jacobian_full(
        lay, opts.jac, clones, uv.reshape(B, G * N, K, 2), masks.reshape(B, G * N, K),
        p_f.reshape(B, G * N, 3), p_f.reshape(B, G * N, 3), opts.sigma_px,
        cp=cp_f, cp_fej=cp_f, has_plane=ones, plane_in_state=~ones,
        plane_slot=torch.zeros(B, G * N, dtype=torch.int64, device=masks.device), sigma_c=sc)
    okf = fvalid.reshape(B, G * N).to(H_x.dtype)
    H_x = H_x * okf[..., None, None]
    H_f = H_f * okf[..., None, None]
    res = res * okf[..., None]
    if valid is not None:
        vg = valid[:, :, None].expand(B, G, N).reshape(B, G * N).to(H_x.dtype)
        H_x = H_x * vg[..., None, None]
        H_f = H_f * vg[..., None, None]
        res = res * vg[..., None]
    stacked = torch.cat([H_f[..., 3:6], H_x, res[..., None]], dim=-1)
    proj, _ = ekf.nullspace_project(H_f[..., 0:3], stacked, res)       # [B, G·N, 3K−3, 3+D+1]
    n_rows = (rmask & fvalid.reshape(B, G * N)[..., None]).reshape(B, G, N * 3 * K).sum(dim=-1)
    return proj.reshape(B, G, N * (3 * K - 3), 3 + D + 1), n_rows


def compress_rows(big: torch.Tensor, use_info: bool) -> torch.Tensor:
    """Compressed rows of stacked [..., R, C] blocks: the information form
    (C rows) or thin QR (min(R, C) rows)."""
    if use_info:
        return ekf.info_compress_rows(big)
    zeros = torch.zeros(big.shape[:-1], dtype=big.dtype, device=big.device)
    return ekf.measurement_compress(big, zeros)[0]


def gather_support(bank: fb.FeatureBank, rows: torch.Tensor, fvalid: torch.Tensor, clone_active: torch.Tensor):
    """(uv, uvn, masks) of the bank rows [B, J] (masks ANDed with fvalid [B, J]
    and the live clones [B, K])."""
    uv = fb._take(bank.uv, rows)
    uvn = fb._take(bank.uvn, rows)
    masks = fb._take(bank.mask, rows) & fvalid[..., None] & clone_active[:, None, :]
    return uv, uvn, masks


def fit_and_refine(opts: PlaneInitOptions, clones, uvn, masks, fvalid, p_f, valid, min_feat: int, max_cond: float):
    """Plane fit + joint refine of groups [B, G, N] (plane_init.py:134-174 and
    plane_msckf.py:123-169 of the JAX package). Returns (cp, p_f, fvalid,
    masks, valid, sigma_c)."""
    dtype = p_f.dtype
    cp0, cond, fit_ok = fit_plane_lsq(p_f, fvalid)
    valid = valid & fit_ok & (cond <= max_cond) & (fvalid.sum(dim=-1) >= min_feat)
    p_tri = p_f
    R_GtoC, p_CinG = clones.R_GtoC[:, None], clones.p_CinG[:, None]
    if opts.use_refine_plane_feat:
        cp, p_f2, ref_ok, inl = refine_plane_joint(cp0, p_f, uvn, masks, fvalid, torch.zeros_like(fvalid),
                                                   R_GtoC, p_CinG, opts.refine)
        if opts.refine.max_error_threshold > 0.0:
            # A failed refine aborts the group; only re-accepted inliers keep rows.
            valid = valid & ref_ok
            fvalid = fvalid & inl
            masks = masks & fvalid[..., None]
            valid = valid & (fvalid.sum(dim=-1) >= min_feat)
            p_f = p_f2
        else:
            cp = torch.where(ref_ok[..., None], cp, cp0)
            p_f = torch.where(ref_ok[..., None, None], p_f2, p_f)
    else:
        cp = cp0
    sigma_c = opts.sigma_c
    if opts.sigma_c_adaptive:
        sigma_c = adaptive_sigma_c(cp, fvalid, p_tri, p_f, opts.sigma_c).to(dtype)
    return cp, p_f, fvalid, masks, valid, sigma_c


def plane_delayed_init(state: VioState, bank: fb.FeatureBank, opts: PlaneInitOptions, cur_slot: torch.Tensor):
    """Try to initialize new CP plane states. Returns (state, bank, n_inited [B])."""
    lay = state.layout
    K, D, P = lay.max_clones, lay.dim, lay.max_planes
    dtype, dev = state.imu.dtype, state.imu.device
    B, F = bank.fid.shape
    Mp = opts.max_msckf_plane
    table = chi2_table(dtype, dev)
    clone_active = torch.isfinite(state.clones_t)

    # Candidate planes: distinct ids among eligible features, by support.
    eligible = bank.active & ~bank.is_slam & (bank.planeid >= 0) & (bank.n_obs >= 2)
    pid = torch.where(eligible, bank.planeid, -1)
    in_state = ((pid[:, :, None] == state.plane_id[:, None, :]) & state.plane_active[:, None, :]).any(dim=-1)
    count, is_first = distinct_candidates(pid)
    score = torch.where(is_first & ~in_state & (count >= opts.plane_init_min_feat), count, -1)
    cand_scores, cand_rows = topk_first_index(score, opts.max_inits_per_frame)
    cand_pids = torch.where(cand_scores > 0, pid.gather(1, cand_rows), -1)

    n_inited = torch.zeros(B, dtype=torch.int64, device=dev)
    slot_ids = torch.arange(P, device=dev)
    f_ids = torch.arange(F, device=dev)
    for c in range(opts.max_inits_per_frame):
        st, bk = state, bank
        plane = cand_pids[:, c]
        valid = plane >= 0
        free = ~st.plane_active
        slot = first_true(free)
        valid = valid & free.any(dim=-1)

        on_plane = bk.active & ~bk.is_slam & (bk.planeid == plane[:, None]) & valid[:, None]
        fs, fidx = topk_first_index(torch.where(on_plane, bk.n_obs, -1), Mp)
        fvalid = fs >= 2
        uv, uvn, masks = gather_support(bk, fidx, fvalid, clone_active)

        clones = clone_set_from_state(st)
        p_f, tri_ok = triangulate(uvn, masks, clones.R_GtoC, clones.p_CinG, opts.tri)
        fvalid = fvalid & tri_ok
        masks = masks & fvalid[..., None]
        if opts.use_ransac:
            _, inl, r_ok = plane_ransac(p_f, fvalid, ransac_draws(plane, opts.ransac.num_hyps, Mp, dtype),
                                        opts.ransac)
            fvalid = torch.where(r_ok[:, None], fvalid & inl, fvalid)
            masks = masks & fvalid[..., None]

        # One group per stream: the [B, G=1, ...] form of the shared helpers.
        cp, p_f, fvalid1, masks1, valid1, sigma_c = fit_and_refine(
            opts, clones, uvn[:, None], masks[:, None], fvalid[:, None], p_f[:, None], valid[:, None],
            opts.plane_init_min_feat, opts.plane_init_max_cond)
        big, n_rows = project_plane_features(lay, opts, clones, uv[:, None], masks1, p_f, fvalid1, cp, sigma_c)
        cp, fvalid, valid, big, n_rows = cp[:, 0], fvalid1[:, 0], valid1[:, 0], big[:, 0], n_rows[:, 0]
        bigc = compress_rows(big, opts.use_info_compression)
        H_cp_c, H_x_c, res_c = bigc[..., 0:3], bigc[..., 3:3 + D], bigc[..., 3 + D]

        # QR split on the CP columns: invertible init + update portions.
        HL_i, HR_i, res_i, HR_u, res_u = ekf.qr_init_split(H_cp_c, H_x_c, res_c)
        r_mult = opts.const_init_multi
        r_u = torch.full_like(res_u, r_mult)
        chi2 = ekf.innovation_chi2(st.cov, HR_u, res_u, r_u)
        # dof: the rows fed to initialize, after the per-feature point nullspaces.
        dof = torch.clamp(n_rows - 3 * fvalid.sum(dim=-1), min=1)
        passed = chi2 <= opts.const_init_chi2 * table[dof.clamp(1, table.shape[0] - 1)]
        diag_ok = (torch.abs(torch.diagonal(HL_i, dim1=-2, dim2=-1)) > 1e-8).all(dim=-1)
        do_init = valid & passed & diag_ok

        slot_col = lay.plane_base + 3 * slot
        new_cov, dx_new = ekf.initialize_invertible(st, slot_col, HR_i, HL_i, torch.full_like(res_i, r_mult), res_i)
        cp_init = cp + dx_new
        at = (slot_ids[None, :] == slot[:, None])                           # [B, P]
        st_new = st.replace(
            cov=new_cov,
            plane_cp=torch.where(at[..., None], cp_init[:, None, :], st.plane_cp),
            plane_cp_fej=torch.where(at[..., None], cp_init[:, None, :], st.plane_cp_fej),
            plane_id=torch.where(at, plane[:, None].to(st.plane_id.dtype), st.plane_id),
            plane_active=st.plane_active | at,
        )
        st_upd, _ = ekf.ekf_update(st_new, HR_u, res_u, r_u)
        state = tree_where(do_init, st_upd, st)

        # Consume the used features (a membership test, not a scatter).
        consumed = ((f_ids[None, :, None] == fidx[:, None, :]) & fvalid[:, None, :]).any(dim=-1)
        bank = tree_where(do_init, fb.free_rows(bk, consumed), bk)
        n_inited = n_inited + do_init.to(torch.int64)
    return state, bank, n_inited


def merge_planes(state: VioState, merge_from: torch.Tensor, merge_into: torch.Tensor,
                 sigma_merge: float, merge_chi2_mult: float, merge_deg_max: float):
    """Frontend plane-id merges (StateHelper::merge_planes_and_marginalize).

    merge_from / merge_into [B, Q] int (−1 pad): "old id from is now id
    into". Only ``from`` in the state → its slot is renamed; both in the
    state → the pseudo-measurement cp_into − cp_from = 0 (noise σ_merge),
    χ² and normal-angle gated, then ``from`` is marginalized. The pairs are
    taken in order (each conditions the next). Returns (state, n_merged [B])."""
    lay = state.layout
    D, P = lay.dim, lay.max_planes
    dtype, dev = state.imu.dtype, state.imu.device
    B = merge_from.shape[0]
    table = chi2_table(dtype, dev)
    white = 1.0 / sigma_merge
    slot_ids = torch.arange(P, device=dev)
    j = torch.arange(D, device=dev)
    eye_w = white * torch.eye(3, dtype=dtype, device=dev)
    ones3 = torch.ones(B, 3, dtype=dtype, device=dev)
    n_merged = torch.zeros(B, dtype=torch.int64, device=dev)

    def block_at(col):
        """[B, 3, D]: white·I at the columns [col, col + 3), zero elsewhere."""
        k_of = (j[None, :] - col[:, None]).clamp(0, 2)                      # [B, D]
        inside = (j[None, :] >= col[:, None]) & (j[None, :] < col[:, None] + 3)
        return torch.where(inside[:, None, :], eye_w[:, k_of].permute(1, 0, 2), 0.0), inside

    for q in range(merge_from.shape[1]):
        st = state
        pid_from, pid_into = merge_from[:, q], merge_into[:, q]
        valid = (pid_from >= 0) & (pid_into >= 0) & (pid_from != pid_into)
        eq_f = (st.plane_id == pid_from[:, None]) & st.plane_active
        eq_i = (st.plane_id == pid_into[:, None]) & st.plane_active
        has_f, has_i = eq_f.any(dim=-1), eq_i.any(dim=-1)
        slot_f, slot_i = first_true(eq_f), first_true(eq_i)
        at_f = slot_ids[None, :] == slot_f[:, None]

        # Case 1: rename only.
        rename = valid & has_f & ~has_i
        plane_id_renamed = torch.where(rename[:, None] & at_f, pid_into[:, None].to(st.plane_id.dtype), st.plane_id)

        # Case 2: both in the state -> gated merge update, marginalize `from`.
        both = valid & has_f & has_i
        cp_new = st.plane_cp.gather(1, slot_i[:, None, None].expand(B, 1, 3))[:, 0]
        cp_old = st.plane_cp.gather(1, slot_f[:, None, None].expand(B, 1, 3))[:, 0]
        n_new = cp_new / torch.clamp(torch.linalg.vector_norm(cp_new, dim=-1), min=1e-9)[:, None]
        n_old = cp_old / torch.clamp(torch.linalg.vector_norm(cp_old, dim=-1), min=1e-9)[:, None]
        angle = torch.rad2deg(torch.arccos(torch.clamp(torch.sum(n_new * n_old, dim=-1), -1.0, 1.0)))

        res = white * (0.0 - (cp_new - cp_old))
        col_i = lay.plane_base + 3 * slot_i
        col_f = lay.plane_base + 3 * slot_f
        H_i, _ = block_at(col_i)
        H_f, in_f = block_at(col_f)
        H = torch.where(in_f[:, None, :], -H_f, H_i)                      # `from` written last, as JAX does
        chi2 = ekf.innovation_chi2(st.cov, H, res, ones3)
        pass_gate = (chi2 < merge_chi2_mult * table[3]) & (angle < merge_deg_max)
        st_upd, _ = ekf.ekf_update(st, H, res, ones3)
        do_update = both & pass_gate
        st1 = tree_where(do_update, st_upd, st)
        # The old plane is marginalized whenever both exist (reference :732-734).
        cov_m = torch.where(both[:, None, None], ekf.zero_slot(st1.cov, col_f, 3), st1.cov)
        state = st1.replace(
            cov=cov_m,
            plane_active=torch.where(both[:, None] & at_f, False, st1.plane_active),
            plane_id=torch.where(both[:, None], torch.where(at_f, -1, st1.plane_id), plane_id_renamed),
        )
        n_merged = n_merged + do_update.to(torch.int64)
    return state, n_merged


def marginalize_unseen_planes(state: VioState, bank: fb.FeatureBank, cur_slot: torch.Tensor):
    """Marginalize plane states with no supporting feature observed in the
    current clone slot [B] (StateHelper.cpp:738-757). Returns (state, n [B])."""
    lay = state.layout
    K = bank.mask.shape[-1]
    at_cur = (bank.mask & fb._slot_onehot(cur_slot, K)[:, None, :]).any(dim=-1)
    seen_feat = bank.active & at_cur & (bank.planeid >= 0)                     # [B, F]
    supported = (seen_feat[:, None, :] & (bank.planeid[:, None, :] == state.plane_id[:, :, None])).any(dim=-1)
    drop = state.plane_active & ~supported                                     # [B, P]
    pl = lay.plane_base
    keep = torch.ones(state.cov.shape[:2], dtype=state.cov.dtype, device=state.cov.device)
    keep[:, pl:pl + 3 * lay.max_planes] = (~drop).to(keep.dtype).repeat_interleave(3, dim=-1)
    return state.replace(
        cov=state.cov * keep[:, None, :] * keep[:, :, None],
        plane_active=state.plane_active & ~drop,
        plane_id=torch.where(drop, -1, state.plane_id),
    ), drop.sum(dim=-1)
