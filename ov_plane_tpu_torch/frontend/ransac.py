"""Gyro-aided two-point RANSAC and gyro integration over a leading stream
dimension.

Counterpart of ``ov_plane_tpu/frontend/ransac.py``. With the inter-frame
rotation R known from the gyro, each correspondence pins the translation to
a plane, t ⟂ m with m = (R b1) × b2, and two of them give a hypothesis
t ∝ m_i × m_j. K fixed hypothesis pairs come from integer hashes of the
hypothesis index over the valid set; the inlier test is one [K, N] matrix.
The hashes run in int64, as the JAX package runs them with x64 on.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ov_plane_tpu_torch.ops.quat import exp_so3


class RansacOptions(NamedTuple):
    num_hypotheses: int = 64
    thresh: float = 2e-3       # |t̂·m̂| threshold (≈ angular epipolar error, rad)
    min_inlier_ratio: float = 0.3


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2])


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(_norm(v), min=1e-12)[..., None]


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a × b with each component a fused multiply-add, fma(a_i, b_j, −a_j·b_i),
    as XLA's CPU code computes ``jnp.cross``. It matters for a hypothesis that
    pairs a track with itself: its float32 cross product is then a rounding
    residue whose direction, once normalized, explains few matches, where an
    exact 0 would explain every match and win. In float32 the fused form is
    exact through float64; a float64 residue is below the normalization's
    1e-12 floor either way."""
    pairs = ((1, 2), (2, 0), (0, 1))
    if a.dtype == torch.float32:
        a64, b64 = a.to(torch.float64), b.to(torch.float64)
        return torch.stack([(a64[..., i] * b64[..., j] - (a[..., j] * b[..., i]).to(torch.float64)).to(a.dtype)
                            for i, j in pairs], dim=-1)
    return torch.stack([a[..., i] * b[..., j] - a[..., j] * b[..., i] for i, j in pairs], dim=-1)


def gyro_ransac(uvn1: torch.Tensor, uvn2: torch.Tensor, mask: torch.Tensor, R_1to2: torch.Tensor,
                opts: RansacOptions):
    """Inliers of the rotation-compensated epipolar model.

    uvn1/uvn2 [B, N, 2] normalized coordinates in frames 1/2; mask [B, N];
    R_1to2 [B, 3, 3]. Returns (inliers [B, N], best_t [B, 3], n_inliers [B])."""
    B, N = mask.shape
    ones = torch.ones_like(uvn1[..., :1])
    b1 = _unit(torch.cat([uvn1, ones], dim=-1))
    b2 = _unit(torch.cat([uvn2, ones], dim=-1))
    m = _cross(b1 @ R_1to2.transpose(-1, -2), b2)                    # [B, N, 3]
    m_norm = _norm(m)
    degenerate = m_norm < 1e-6          # a pure-rotation match satisfies any t
    m_hat = m / torch.clamp(m_norm, min=1e-12)[..., None]

    K = opts.num_hypotheses
    order = torch.argsort((~mask).to(torch.uint8), dim=-1, stable=True)          # valid entries first
    n_valid = torch.clamp(mask.sum(dim=-1), min=2)[:, None]                      # int64
    h = torch.arange(K, dtype=torch.int64, device=mask.device)[None]
    i1 = order.gather(1, (h * 2654435761) % n_valid)
    i2 = order.gather(1, (h * 40503 + 17) % n_valid)
    pick = lambda i: m_hat.gather(1, i[..., None].expand(B, K, 3))  # noqa: E731
    t_hyp = _unit(_cross(pick(i1), pick(i2)))                                    # [B, K, 3]

    err = torch.abs(t_hyp @ m_hat.transpose(-1, -2))                             # [B, K, N]
    ok = ((err < opts.thresh) & mask[:, None, :]) | (degenerate & mask)[:, None, :]
    scores = ok.sum(dim=-1)                                                      # [B, K]
    best = torch.argmax(scores, dim=-1)                                          # first maximum
    inliers = ok.gather(1, best[:, None, None].expand(B, 1, N))[:, 0]
    n_in = scores.gather(1, best[:, None])[:, 0]
    # Fall back to "all valid" when the model explains too few (t ≈ 0).
    ratio = n_in.to(torch.float64) / torch.clamp(mask.sum(dim=-1), min=1).to(torch.float64)
    inliers = torch.where((ratio >= opts.min_inlier_ratio)[:, None], inliers, mask)
    return inliers, t_hyp.gather(1, best[:, None, None].expand(B, 1, 3))[:, 0], n_in


def integrate_gyro(imu_t: torch.Tensor, imu_w: torch.Tensor, t0: torch.Tensor, t1: torch.Tensor,
                   bg: torch.Tensor) -> torch.Tensor:
    """Relative rotation R_I0→I1 [B, 3, 3] from the gyro samples over
    [t0, t1]: imu_t [B, W] (+inf padding), imu_w [B, W, 3], t0/t1 [B],
    bg [B, 3]. The sample rotations are made at once; their product is taken
    in the scan's order, R ← dR_k R."""
    ta = torch.minimum(torch.maximum(imu_t[:, :-1], t0[:, None]), t1[:, None])
    tb = torch.minimum(torch.maximum(imu_t[:, 1:], t0[:, None]), t1[:, None])
    d = tb - ta
    dt = torch.where(torch.isfinite(d), torch.clamp(d, min=0.0), torch.zeros_like(d))
    dR = exp_so3(-(imu_w[:, :-1] - bg[:, None, :]) * dt[..., None])              # [B, W-1, 3, 3]
    R = torch.eye(3, dtype=imu_w.dtype, device=imu_w.device).expand(imu_w.shape[0], 3, 3)
    for k in range(dR.shape[1]):
        R = dR[:, k] @ R
    return R
