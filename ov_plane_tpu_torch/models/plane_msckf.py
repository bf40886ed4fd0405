"""Grouped MSCKF updates for planes that are not in the state.

Counterpart of ``ov_plane_tpu/models/plane_msckf.py`` for B streams (the
plane half of UpdaterMSCKF::update): the features of the frame's MSCKF
selection that share an out-of-state plane are updated together. Per group
the CP is recovered (LSQ fit + joint refine), each feature's point columns
are nullspace-projected (keeping the CP), the group's stack is compressed,
its CP columns are projected away, and it is χ²-gated against the shared
pre-update covariance. The JAX package vmaps the group body; here the groups
are a tensor dimension, [B, G = max_planes_per_frame, Mp = max_msckf_plane].
The surviving groups' rows stack, are compressed again to D+1 rows, and go
through one EKF update.

The consumed features are left out of the classic point update (the caller
gets a mask back).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ov_plane_tpu_torch.models import feature_bank as fb
from ov_plane_tpu_torch.models.feature_bank import topk_first_index
from ov_plane_tpu_torch.models.jacobians import clone_set_from_state
from ov_plane_tpu_torch.models.msckf import chi2_table
from ov_plane_tpu_torch.models.plane_init import (
    PlaneInitOptions,
    compress_rows,
    distinct_candidates,
    fit_and_refine,
    gather_support,
    project_plane_features,
)
from ov_plane_tpu_torch.ops import ekf
from ov_plane_tpu_torch.ops.triangulation import triangulate
from ov_plane_tpu_torch.state.vio_state import VioState, tree_where


class PlaneMsckfOptions(NamedTuple):
    base: PlaneInitOptions = PlaneInitOptions()
    chi2_multipler: float = 5.0
    plane_msckf_min_feat: int = 5
    plane_msckf_max_cond: float = 50.0
    # Static bound on grouped updates per frame (the reference has none):
    # qualifying groups beyond it are counted, never silently dropped.
    max_planes_per_frame: int = 8


def msckf_plane_update(state: VioState, bank: fb.FeatureBank, opts: PlaneMsckfOptions,
                       sel_idx: torch.Tensor, sel_valid: torch.Tensor):
    """Grouped plane updates over the MSCKF selection sel_idx / sel_valid
    [B, M]. Returns (new_state, consumed [B, M], n_updated [B], n_dropped [B]):
    n_dropped counts the qualifying groups beyond ``max_planes_per_frame``."""
    lay = state.layout
    K, D = lay.max_clones, lay.dim
    dtype, dev = state.imu.dtype, state.imu.device
    B, M = sel_idx.shape
    G, Mp = opts.max_planes_per_frame, opts.base.max_msckf_plane
    table = chi2_table(dtype, dev)
    clone_active = torch.isfinite(state.clones_t)

    pid = torch.where(sel_valid, bank.planeid.gather(1, sel_idx), -1)
    in_state = ((pid[:, :, None] == state.plane_id[:, None, :]) & state.plane_active[:, None, :]).any(dim=-1)
    pid = torch.where(in_state, -1, pid)                                # out-of-state planes only

    # Distinct candidate planes among the selection, ranked by support.
    count, is_first = distinct_candidates(pid)
    score = torch.where(is_first & (count >= opts.plane_msckf_min_feat), count, -1)
    cand_scores, cand_pos = topk_first_index(score, G)
    cand_pids = torch.where(cand_scores > 0, pid.gather(1, cand_pos), -1)   # [B, G]
    n_dropped = torch.clamp((score > 0).sum(dim=-1) - G, min=0)

    # Every group against the same pre-update state.
    clones = clone_set_from_state(state)
    valid = cand_pids >= 0                                              # [B, G]
    members = (pid[:, None, :] == cand_pids[:, :, None]) & sel_valid[:, None, :] & valid[:, :, None]
    n_obs_sel = bank.n_obs.gather(1, sel_idx)
    fs, fpos = topk_first_index(torch.where(members, n_obs_sel[:, None, :], -1), Mp)   # [B, G, Mp]
    fvalid = fs >= 2
    rows = sel_idx.gather(1, fpos.reshape(B, G * Mp))
    uv, uvn, masks = gather_support(bank, rows, fvalid.reshape(B, G * Mp), clone_active)
    p_f, tri_ok = triangulate(uvn, masks, clones.R_GtoC, clones.p_CinG, opts.base.tri)
    fvalid = fvalid & tri_ok.reshape(B, G, Mp)
    masks = masks.reshape(B, G, Mp, K) & fvalid[..., None]

    cp, p_f, fvalid, masks, valid, sigma_c = fit_and_refine(
        opts.base, clones, uvn.reshape(B, G, Mp, K, 2), masks, fvalid, p_f.reshape(B, G, Mp, 3), valid,
        opts.plane_msckf_min_feat, opts.plane_msckf_max_cond)
    big, n_rows = project_plane_features(lay, opts.base, clones, uv.reshape(B, G, Mp, K, 2), masks, p_f, fvalid,
                                         cp, sigma_c, valid=valid)
    # Compress, then marginalize the CP columns entirely.
    bigc = compress_rows(big, opts.base.use_info_compression)         # [B, G, C', 3+D+1]
    Hcp_c, rest = bigc[..., 0:3], bigc[..., 3:]
    rest2, _ = ekf.nullspace_project(Hcp_c, rest, torch.zeros(rest.shape[:-1], dtype=dtype, device=dev))
    H_up, res_up = rest2[..., :D], rest2[..., D]

    # Gate against the shared pre-update covariance, with the rows left after
    # the per-feature point nullspaces (−3 each) and the CP marginalization (−3).
    chi2 = ekf.innovation_chi2(state.cov[:, None], H_up, res_up, torch.ones_like(res_up))
    dof = torch.clamp(n_rows - 3 * fvalid.sum(dim=-1) - 3, min=1)
    passed = chi2 <= opts.chi2_multipler * table[dof.clamp(1, table.shape[0] - 1)]
    # Non-finite group rows are excluded by a select (NaN·0 = NaN).
    finite = torch.isfinite(H_up).all(dim=-1).all(dim=-1) & torch.isfinite(res_up).all(dim=-1)
    do_update = valid & passed & finite                                 # [B, G]

    used = ((torch.arange(M, device=dev)[None, None, :, None] == fpos[:, :, None, :])
            & fvalid[:, :, None, :]).any(dim=-1)                        # [B, G, M]
    consumed = (valid[:, :, None] & used).any(dim=1)
    H_all = torch.where(do_update[..., None, None], H_up, 0.0)
    res_all = torch.where(do_update[..., None], res_up, 0.0)

    # One stacked update for every surviving group: re-compressed to D+1
    # rows (the update is invariant under orthogonal row transforms).
    stack = torch.cat([H_all.reshape(B, -1, D), res_all.reshape(B, -1, 1)], dim=-1)
    stc = compress_rows(stack, opts.base.use_info_compression)
    H_one, res_one = stc[..., :D], stc[..., D]
    st_new, _ = ekf.ekf_update(state, H_one, res_one, torch.ones_like(res_one))
    new_state = tree_where(do_update.any(dim=-1), st_new, state)
    return new_state, consumed, do_update.sum(dim=-1), n_dropped
