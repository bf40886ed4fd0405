"""Batched MSCKF update of B streams.

Counterpart of ``ov_plane_tpu/models/msckf.py``:

  gathered features → triangulation → stacked Jacobians (with the
  point-on-plane rows of features whose plane is in the state) → per-feature
  Householder nullspace projection → per-feature χ² gate (95% table ×
  multiplier) → stacked rows → compression → one EKF update per stream.

Compression is either the information form (the :func:`kernels.gram_reduce`
kernel, then ``parallel.schur.information_to_compressed``) or thin QR.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ov_plane_tpu_torch.models.jacobians import JacobianOptions, clone_set_from_state, feature_jacobian_full
from ov_plane_tpu_torch.ops import ekf, kernels
from ov_plane_tpu_torch.ops import representations as reps
from ov_plane_tpu_torch.ops.triangulation import TriangulationOptions, triangulate
from ov_plane_tpu_torch.parallel.schur import information_to_compressed
from ov_plane_tpu_torch.state.vio_state import VioState, tree_where
from ov_plane_tpu_torch.utils.chi2 import CHI2_095_TABLE


class MsckfOptions(NamedTuple):
    jac: JacobianOptions = JacobianOptions()
    tri: TriangulationOptions = TriangulationOptions()
    sigma_px: float = 1.0
    chi2_multipler: float = 5.0
    sigma_c: float = 0.05
    use_plane_constraint: bool = False
    use_info_compression: bool = False


@functools.lru_cache(maxsize=8)
def chi2_table(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The χ² table on the device, copied once (not inside every update)."""
    return torch.as_tensor(CHI2_095_TABLE, dtype=dtype, device=device)


def msckf_update(state: VioState, opts: MsckfOptions, sel_uv, sel_uvn, sel_mask,
                 sel_plane_cp=None, sel_plane_cp_fej=None, sel_has_plane=None, sel_plane_in_state=None,
                 sel_plane_slot=None):
    """sel_uv / sel_uvn [B, M, K, 2], sel_mask [B, M, K] (already ANDed with
    the selection validity). The plane arguments [B, M] (CPs [B, M, 3]) give
    each feature's plane; with ``opts.use_plane_constraint`` the features
    with ``sel_has_plane`` get point-on-plane rows. Returns (new_state,
    used [B, M], p_FinG [B, M, 3], tri_ok [B, M])."""
    lay = state.layout
    K, D = lay.max_clones, lay.dim
    B, M = sel_mask.shape[:2]
    dtype = sel_uv.dtype

    sel_mask = sel_mask & torch.isfinite(state.clones_t)[:, None, :]
    clones = clone_set_from_state(state)
    p_f, tri_ok = triangulate(sel_uvn, sel_mask, clones.R_GtoC, clones.p_CinG, opts.tri)

    # FEJ feature value = the fresh triangulation (UpdaterMSCKF).
    use_plane = None
    kw = {}
    if sel_has_plane is not None:
        use_plane = sel_has_plane & opts.use_plane_constraint
        kw = dict(cp=sel_plane_cp, cp_fej=sel_plane_cp_fej, has_plane=use_plane,
                  plane_in_state=sel_plane_in_state, plane_slot=sel_plane_slot, sigma_c=opts.sigma_c)
    if opts.jac.rep != reps.GLOBAL_3D:
        # Anchored representations anchor at the newest observing clone (ov_core
        # sets anchor_clone_timestamp to the feature's last observation).
        slot_t = torch.where(sel_mask, state.clones_t[:, None, :], -torch.inf)
        kw["anchor_slot"] = torch.argmax(slot_t, dim=-1)
    H_x, H_f, res, _ = feature_jacobian_full(lay, opts.jac, clones, sel_uv, sel_mask, p_f, p_f, opts.sigma_px,
                                             **kw)
    okf = tri_ok.to(dtype)
    H_x = H_x * okf[..., None, None]
    H_f = H_f * okf[..., None, None]
    res = res * okf[..., None]

    Hxr2, _ = ekf.nullspace_project(H_f[..., 0:3], torch.cat([H_x, res[..., None]], dim=-1), res)
    H_x2 = Hxr2[..., :D]                                        # [B, M, 3K−3, D]
    res2 = Hxr2[..., D]

    # Per-feature χ² gate: S = H2 P H2ᵀ + I (whitened rows).
    S = H_x2 @ (state.cov[:, None] @ H_x2.transpose(-1, -2))
    S = S + torch.eye(S.shape[-1], dtype=dtype, device=S.device)
    L = ekf.cholesky_or_nan(S)
    chi2 = (res2[..., None, :] @ torch.cholesky_solve(res2[..., None], L))[..., 0, 0]
    n_obs = sel_mask.sum(dim=-1)
    dof_rows = 2 * n_obs - 3 if use_plane is None else torch.where(use_plane, 3 * n_obs, 2 * n_obs) - 3
    table = chi2_table(dtype, S.device)
    gate = chi2 <= opts.chi2_multipler * table[dof_rows.clamp(1, table.shape[0] - 1)]
    passed = tri_ok & gate & (n_obs >= 2)

    pf = passed.to(dtype)
    H_big = (H_x2 * pf[..., None, None]).reshape(B, M * (3 * K - 3), D)
    r_big = (res2 * pf[..., None]).reshape(B, M * (3 * K - 3))
    if opts.use_info_compression:
        lam, eta = kernels.gram_reduce(H_big, r_big)
        H_c, r_c = information_to_compressed(lam, eta)
    else:
        H_c, r_c = ekf.measurement_compress(H_big, r_big)
    r_diag = torch.ones(H_c.shape[-2], dtype=dtype, device=H_c.device)
    dx, new_cov, _ = ekf.kalman_update(state.cov, H_c, r_c, r_diag)
    new_state = ekf.apply_dx(state.replace(cov=new_cov), dx)
    new_state = tree_where(passed.any(dim=-1), new_state, state)
    return new_state, passed, p_f, tri_ok
