"""Accuracy and consistency metrics (counterpart of ``ov_plane_tpu/eval/metrics.py``).

Orientation error e_θ = 2·vec(q_est ⊗ q_gt⁻¹) (JPL small angle), position
error e_p = p_est − p_gt; NEES with the filter's own diagonal covariance.
Inputs are [..., T, n]; reductions run over the frame axis T.
"""

from __future__ import annotations

import math

import torch

from ov_plane_tpu_torch.ops.quat import quat_inv, quat_multiply


def ori_pos_errors(q_est, p_est, q_gt, p_gt):
    dq = quat_multiply(q_est, quat_inv(q_gt))
    return 2.0 * dq[..., 0:3], p_est - p_gt


def rmse_nees(q_est, p_est, cov_th_diag, cov_p_diag, q_gt, p_gt, valid=None):
    """Per-sequence RMSE + NEES (diagonal covariance approximation)."""
    e_th, e_p = ori_pos_errors(q_est, p_est, q_gt, p_gt)
    if valid is None:
        valid = torch.ones(e_th.shape[:-1], dtype=torch.bool, device=e_th.device)
    w = valid.to(e_th.dtype)
    n = torch.clamp(w.sum(-1), min=1.0)
    rmse_ori_deg = torch.sqrt((w * (e_th**2).sum(-1)).sum(-1) / n) * (180.0 / math.pi)
    rmse_pos = torch.sqrt((w * (e_p**2).sum(-1)).sum(-1) / n)
    nees_ori = (w * (e_th**2 / torch.clamp(cov_th_diag, min=1e-18)).sum(-1)).sum(-1) / n
    nees_pos = (w * (e_p**2 / torch.clamp(cov_p_diag, min=1e-18)).sum(-1)).sum(-1) / n
    return dict(rmse_ori_deg=rmse_ori_deg, rmse_pos=rmse_pos, nees_ori=nees_ori, nees_pos=nees_pos)
