"""VioState: the filter state of B independent streams as fixed-shape tensors.

Counterpart of ``ov_plane_tpu/state/vio_state.py``. Every tensor field has a
leading stream dimension ``[B, ...]`` (the JAX package vmaps a per-stream
pytree instead). Which slots are alive is carried in masks and timestamps,
exactly as there. Conventions: JPL quaternions ``[x, y, z, w]`` for R_GtoI,
positions in the global frame.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ov_plane_tpu_torch.state.layout import StateLayout
from ov_plane_tpu_torch.utils.torchenv import resolve_device


def _where(pred: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-stream select: pred [B] broadcast over a's trailing dims."""
    return torch.where(pred.reshape(pred.shape + (1,) * (a.dim() - 1)), a, b)


@dataclass
class TensorTree:
    """Dataclass whose fields (other than ``layout``) are [B, ...] tensors."""

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)

    def tensors(self):
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
                if isinstance(getattr(self, f.name), torch.Tensor)}


def tree_where(pred: torch.Tensor, a: TensorTree, b: TensorTree) -> TensorTree:
    """Field-wise ``torch.where(pred[B], a, b)`` over two trees of one type."""
    tb = b.tensors()
    return a.replace(**{k: _where(pred, v, tb[k]) for k, v in a.tensors().items()})


@dataclass
class VioState(TensorTree):
    layout: StateLayout
    t: torch.Tensor          # [B] camera-clock time of the estimate
    last_dt: torch.Tensor    # [B] calib_dt used by the last propagation
    startup_t: torch.Tensor  # [B]
    has_moved: torch.Tensor  # [B] bool
    imu: torch.Tensor        # [B, 16]: q(4), p(3), v(3), bg(3), ba(3)
    imu_fej: torch.Tensor
    calib_dt: torch.Tensor   # [B]
    calib_cam: torch.Tensor  # [B, 7]: q_ItoC(4), p_IinC(3)
    cam_zeta: torch.Tensor   # [B, 8]
    clones_q: torch.Tensor   # [B, K, 4]
    clones_p: torch.Tensor   # [B, K, 3]
    clones_q_fej: torch.Tensor
    clones_p_fej: torch.Tensor
    clones_t: torch.Tensor   # [B, K], -inf marks a free slot
    # SLAM landmarks: slam_p holds each landmark's representation
    # parameters (the global point for GLOBAL_3D; anchored reps hold
    # anchor-frame parameters and their anchor clone slot).
    slam_p: torch.Tensor     # [B, L, 3]
    slam_p_fej: torch.Tensor
    slam_id: torch.Tensor    # [B, L] int32 feature id, -1 = free
    slam_active: torch.Tensor  # [B, L] bool
    slam_anchor_slot: torch.Tensor  # [B, L] int32 anchor clone slot, -1 = global rep or free
    plane_cp: torch.Tensor   # [B, P, 3]
    plane_cp_fej: torch.Tensor
    plane_id: torch.Tensor   # [B, P] int32
    plane_active: torch.Tensor  # [B, P] bool
    cov: torch.Tensor        # [B, D, D]

    @classmethod
    def create(cls, layout: StateLayout, batch: int, dtype=torch.float64, device="cuda") -> "VioState":
        B, K, L, P = batch, layout.max_clones, layout.max_slam, layout.max_planes
        device = resolve_device(device)
        kw = dict(dtype=dtype, device=device)
        unit_q = torch.tensor([0.0, 0.0, 0.0, 1.0], **kw)
        imu = torch.zeros(B, 16, **kw)
        imu[:, 3] = 1.0
        zeros = lambda *s: torch.zeros(B, *s, **kw)  # noqa: E731
        return cls(
            layout=layout,
            t=zeros(), last_dt=zeros(), startup_t=zeros(),
            has_moved=torch.zeros(B, dtype=torch.bool, device=device),
            imu=imu, imu_fej=imu.clone(),
            calib_dt=zeros(),
            calib_cam=torch.cat([unit_q, torch.zeros(3, **kw)]).expand(B, 7).clone(),
            cam_zeta=zeros(8),
            clones_q=unit_q.expand(B, K, 4).clone(), clones_p=zeros(K, 3),
            clones_q_fej=unit_q.expand(B, K, 4).clone(), clones_p_fej=zeros(K, 3),
            clones_t=torch.full((B, K), -float("inf"), **kw),
            slam_p=zeros(L, 3), slam_p_fej=zeros(L, 3),
            slam_id=torch.full((B, L), -1, dtype=torch.int32, device=device),
            slam_active=torch.zeros(B, L, dtype=torch.bool, device=device),
            slam_anchor_slot=torch.full((B, L), -1, dtype=torch.int32, device=device),
            plane_cp=zeros(P, 3), plane_cp_fej=zeros(P, 3),
            plane_id=torch.full((B, P), -1, dtype=torch.int32, device=device),
            plane_active=torch.zeros(B, P, dtype=torch.bool, device=device),
            cov=zeros(layout.dim, layout.dim),
        )

    @property
    def num_clones(self) -> torch.Tensor:
        return torch.isfinite(self.clones_t).sum(dim=1).to(torch.int32)

    @property
    def oldest_clone_slot(self) -> torch.Tensor:
        """[B] slot of the oldest finite timestamp (first index on ties)."""
        inf = torch.full_like(self.clones_t, float("inf"))
        return torch.argmin(torch.where(torch.isfinite(self.clones_t), self.clones_t, inf), dim=1)

    @property
    def newest_clone_slot(self) -> torch.Tensor:
        """[B] slot of the newest finite timestamp (first index on ties, 0 with no clone)."""
        return torch.argmax(torch.where(torch.isfinite(self.clones_t), self.clones_t, -torch.inf), dim=1)
