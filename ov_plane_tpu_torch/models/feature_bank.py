"""Device-resident feature track table of B streams.

Counterpart of ``ov_plane_tpu/models/feature_bank.py``: a fixed-capacity
structure of arrays keyed by clone slot, [B, F, ...]. Observations are stored
per clone slot, so they age out when that clone is marginalized. Id matching
and row allocation are O(O·F) masked comparisons with gathers; clone slots
that differ per stream ([B] tensors) are applied as one-hot selects.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ov_plane_tpu_torch.state.vio_state import TensorTree
from ov_plane_tpu_torch.utils.torchenv import resolve_device


@dataclass
class FeatureBank(TensorTree):
    fid: torch.Tensor       # [B, F] int32 feature id, -1 = free row
    uv: torch.Tensor        # [B, F, K, 2] distorted pixels per clone slot
    uvn: torch.Tensor       # [B, F, K, 2] normalized undistorted observations
    mask: torch.Tensor      # [B, F, K] bool
    planeid: torch.Tensor   # [B, F] int32 (-1 none)
    is_slam: torch.Tensor   # [B, F] bool
    slam_slot: torch.Tensor  # [B, F] int32
    # Simulator truth of each feature (use_groundtruths; zeros otherwise).
    gt_p: torch.Tensor      # [B, F, 3] true feature position
    gt_cp: torch.Tensor     # [B, F, 3] true CP of the feature's plane

    @classmethod
    def create(cls, max_features: int, max_clones: int, batch: int, dtype=torch.float64,
               device="cuda") -> "FeatureBank":
        B, F, K = batch, max_features, max_clones
        device = resolve_device(device)
        i32 = dict(dtype=torch.int32, device=device)
        return cls(
            fid=torch.full((B, F), -1, **i32),
            uv=torch.zeros(B, F, K, 2, dtype=dtype, device=device),
            uvn=torch.zeros(B, F, K, 2, dtype=dtype, device=device),
            mask=torch.zeros(B, F, K, dtype=torch.bool, device=device),
            planeid=torch.full((B, F), -1, **i32),
            is_slam=torch.zeros(B, F, dtype=torch.bool, device=device),
            slam_slot=torch.full((B, F), -1, **i32),
            gt_p=torch.zeros(B, F, 3, dtype=dtype, device=device),
            gt_cp=torch.zeros(B, F, 3, dtype=dtype, device=device),
        )

    @property
    def active(self) -> torch.Tensor:
        return self.fid >= 0

    @property
    def n_obs(self) -> torch.Tensor:
        return self.mask.sum(dim=-1)


def _slot_onehot(slot: torch.Tensor, K: int) -> torch.Tensor:
    return torch.nn.functional.one_hot(slot, K).bool()          # [B, K]


def clear_clone_column(bank: FeatureBank, slot: torch.Tensor) -> FeatureBank:
    """Drop the observations of clone slot [B] and free rows left with none
    (unless SLAM states)."""
    mask = bank.mask & ~_slot_onehot(slot, bank.mask.shape[-1])[:, None, :]
    gone = (mask.sum(dim=-1) == 0) & bank.active & ~bank.is_slam
    return bank.replace(
        mask=mask,
        fid=torch.where(gone, -1, bank.fid),
        planeid=torch.where(gone, -1, bank.planeid),
    )


def topk_first_index(score: torch.Tensor, k: int):
    """Top-k of integer scores [..., F] along the last dim, ties broken
    towards the lower index (``jax.lax.top_k`` order): the key
    score·F + (F−1−idx) is unique."""
    F = score.shape[-1]
    idx = torch.arange(F, device=score.device)
    key = score.to(torch.int64) * F + (F - 1 - idx)
    _, sel = torch.topk(key, k, dim=-1, largest=True, sorted=True)
    return score.gather(-1, sel), sel


def first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last dim (0 where there is none),
    as ``jnp.argmax`` gives it on a bool array."""
    return torch.argmax(mask.to(torch.int32), dim=-1)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, ...] gathered at idx [B, J] along dim 1 -> [B, J, ...]."""
    tail = x.shape[2:]
    index = idx.reshape(idx.shape + (1,) * len(tail)).expand(*idx.shape, *tail)
    return x.gather(1, index)


def ingest(bank: FeatureBank, ids, uv, uvn, plane, slot, gt_p=None, gt_cp=None) -> FeatureBank:
    """Insert one frame's observations at clone slot ``slot`` [B].

    ids [B, O] int (-1 padding); uv/uvn [B, O, 2]; plane [B, O] int. Existing
    ids update in place (refreshing the plane association); new ids claim
    free rows in order; overflow observations are dropped. Stale
    observations at the recycled slot are cleared first. The optional
    per-observation truth gt_p / gt_cp [B, O, 3] is stored with the rows
    they feed; without it the truth columns keep their zeros (the JAX
    package writes zeros there, the same values).
    """
    K = bank.mask.shape[-1]
    valid = ids >= 0
    oh = _slot_onehot(slot, K)                                  # [B, K]
    mask_pre = bank.mask & ~oh[:, None, :]
    gone = ~mask_pre.any(dim=-1) & bank.active & ~bank.is_slam
    fid_pre = torch.where(gone, -1, bank.fid)
    planeid_pre = torch.where(gone, -1, bank.planeid)

    eq = (ids[:, :, None] == fid_pre[:, None, :]) & (fid_pre >= 0)[:, None, :]   # [B, O, F]
    has_match = eq.any(dim=-1)
    # The r-th new observation claims the r-th free row.
    is_new = valid & ~has_match
    free = fid_pre < 0
    free_rank = torch.cumsum(free.to(torch.int32), dim=-1) - 1
    new_rank = torch.cumsum(is_new.to(torch.int32), dim=-1) - 1
    alloc = free[:, :, None] & is_new[:, None, :] & (free_rank[:, :, None] == new_rank[:, None, :])  # [B, F, O]

    hit_of = eq.transpose(1, 2) | alloc
    hit = hit_of.any(dim=-1)
    src = hit_of.to(torch.int32).argmax(dim=-1)                 # [B, F] first feeding observation
    is_new_row = alloc.any(dim=-1)

    fid = torch.where(is_new_row, _take(ids, src).to(torch.int32), fid_pre)
    planeid = torch.where(hit, _take(plane, src).to(torch.int32), planeid_pre)
    at_slot = oh[:, None, :]                                    # [B, 1, K]
    mask = torch.where(at_slot, hit[:, :, None], mask_pre)
    hitc = hit[:, :, None]
    uv_col = torch.where(hitc, _take(uv, src), 0.0)
    uvn_col = torch.where(hitc, _take(uvn, src), 0.0)
    uv_all = torch.where(at_slot[..., None], uv_col[:, :, None, :], bank.uv)
    uvn_all = torch.where(at_slot[..., None], uvn_col[:, :, None, :], bank.uvn)
    truth = {name: torch.where(hitc, _take(obs, src).to(bank.gt_p.dtype), getattr(bank, name))
             for name, obs in (("gt_p", gt_p), ("gt_cp", gt_cp)) if obs is not None}
    return bank.replace(fid=fid, uv=uv_all, uvn=uvn_all, mask=mask, planeid=planeid, **truth)


def free_rows(bank: FeatureBank, rows_mask: torch.Tensor) -> FeatureBank:
    """Free the masked rows [B, F] (a feature used in an update is deleted)."""
    return bank.replace(
        fid=torch.where(rows_mask, -1, bank.fid),
        mask=bank.mask & ~rows_mask[:, :, None],
        planeid=torch.where(rows_mask, -1, bank.planeid),
        is_slam=bank.is_slam & ~rows_mask,
        slam_slot=torch.where(rows_mask, -1, bank.slam_slot),
    )
