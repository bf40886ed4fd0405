"""Information-form measurement compression.

Counterpart of ``ov_plane_tpu/parallel/schur.py`` (the single-device part):
the stacked rows (H, r) reduce to the normal equations Λ = HᵀH, η = Hᵀr,
and R = chol(Λ)ᵀ, y = R⁻ᵀη form a system information-equivalent to the
QR-compressed stack (RᵀR = HᵀH, Rᵀy = Hᵀr). Per-stream tensors carry a
leading [B] dimension.
"""

from __future__ import annotations

import torch

from ov_plane_tpu_torch.ops.ekf import cholesky_or_nan


def local_information(H: torch.Tensor, r: torch.Tensor):
    """Normal equations (Λ, η) of one block of rows. Masked rows must be zero."""
    Ht = H.transpose(-1, -2)
    return Ht @ H, (Ht @ r[..., None])[..., 0]


def information_to_compressed(lam: torch.Tensor, eta: torch.Tensor, jitter: float = 0.0):
    """(Λ [B, D, D], η [B, D]) -> (R upper-triangular, y) with RᵀR = Λ, Rᵀy = η.

    The Cholesky is jittered by rel·max(tr(Λ)/D, 1) with rel = 1e-6 in f32 and
    1e-12 in f64. A stream whose factorization still fails gets zero
    information (R = 0, y = 0): its update becomes a no-op.
    """
    d = lam.shape[-1]
    rel = 1e-6 if lam.dtype == torch.float32 else 1e-12
    tr = torch.diagonal(lam, dim1=-2, dim2=-1).sum(-1)
    eps = rel * torch.clamp(tr / d, min=1.0) + jitter
    eye = torch.eye(d, dtype=lam.dtype, device=lam.device)
    L = cholesky_or_nan(lam + eps[:, None, None] * eye)
    bad = ~torch.isfinite(L).all(dim=-1).all(dim=-1)
    L = torch.where(bad[:, None, None], eye.expand_as(L), L)
    R = torch.where(bad[:, None, None], torch.zeros_like(L), L.transpose(-1, -2))
    y = torch.linalg.solve_triangular(L, eta[..., None], upper=False)[..., 0]
    y = torch.where(bad[:, None], torch.zeros_like(y), y)
    return R, y
