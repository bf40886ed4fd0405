"""The device-resident persistent plane map (counterpart of ``ov_plane_tpu/frontend/map_blocks.py``).

A fixed-capacity structure of arrays of points where insertion
deduplicates by voxel against the live set and within the batch (one point
per voxel: the ikd-tree's downsample-on-insert) and recycles the oldest
slots when full, and KNN is a dense masked distance computation with a
stable sort (ties go to the lower index, as ``jax.lax.top_k`` breaks them).
The voxel hash is int64 arithmetic and wraps on overflow, as in the JAX
package. :func:`sharded_knn` splits the points over the ranks of a process
group: a shard-local top-k, an ``all_gather`` of the candidates, and the
global top-k, equal to :func:`knn` on one device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ov_plane_tpu_torch.utils.torchenv import resolve_device


@dataclass
class MapBlocks:
    points: torch.Tensor    # [N, 3]
    plane_id: torch.Tensor  # [N] int32 (-1 free)
    vox: torch.Tensor       # [N] int64 voxel key of each point
    stamp: torch.Tensor     # [N] int32 insertion counter (ring recycling)
    cursor: torch.Tensor    # [] int32 monotonic counter
    voxel: float = 0.1

    @classmethod
    def create(cls, capacity: int, voxel: float = 0.1, dtype=torch.float32, device="cuda") -> "MapBlocks":
        dev = resolve_device(device)
        return cls(points=torch.zeros(capacity, 3, dtype=dtype, device=dev),
                   plane_id=torch.full((capacity,), -1, dtype=torch.int32, device=dev),
                   vox=torch.zeros(capacity, dtype=torch.int64, device=dev),
                   stamp=torch.zeros(capacity, dtype=torch.int32, device=dev),
                   cursor=torch.zeros((), dtype=torch.int32, device=dev), voxel=voxel)

    @property
    def active(self) -> torch.Tensor:
        return self.plane_id >= 0


def _voxel_key(pts: torch.Tensor, voxel: float) -> torch.Tensor:
    q = torch.floor(pts / voxel).to(torch.int64)
    return q[:, 0] * 73856093 + q[:, 1] * 19349669 + q[:, 2] * 83492791


def insert(m: MapBlocks, pts, plane_ids, mask):
    """Insert the masked points [B, 3] (plane ids [B]) with voxel dedup; the
    free slots fill first, then the oldest recycle. Returns (map, inserted)."""
    keys = _voxel_key(pts, m.voxel)
    dup_exist = ((keys[:, None] == m.vox[None, :]) & m.active[None, :]).any(dim=1)
    same = keys[:, None] == keys[None, :]
    lower = torch.tril(torch.ones_like(same), diagonal=-1)
    dup_batch = (same & lower & mask[None, :]).any(dim=1)     # an earlier masked point in the voxel
    take = mask & ~dup_exist & ~dup_batch

    N = m.points.shape[0]
    prio = torch.where(m.active, m.stamp, torch.full_like(m.stamp, -1))
    order = torch.argsort(prio, stable=True)                # free, then oldest
    rank = torch.cumsum(take.to(torch.int64), dim=0) - 1
    put = take & (rank < N)
    slot = torch.where(put, order[torch.clamp(rank, 0, N - 1)], torch.full_like(rank, N))

    def scatter(dst, val):
        ext = torch.cat([dst, torch.zeros_like(dst[:1])])
        ext[slot] = val
        return ext[:N]

    stamp_new = m.cursor + 1
    pts_d = pts.to(m.points.dtype)
    m = MapBlocks(points=scatter(m.points, torch.where(take[:, None], pts_d, torch.zeros_like(pts_d))),
                  plane_id=scatter(m.plane_id, torch.where(take, plane_ids.to(torch.int32), 0).to(torch.int32)),
                  vox=scatter(m.vox, torch.where(take, keys, 0)),
                  stamp=scatter(m.stamp, torch.where(take, stamp_new, 0).to(torch.int32)),
                  cursor=stamp_new, voxel=m.voxel)
    return m, put.sum()


def knn(m: MapBlocks, queries, k: int, plane_filter=None):
    """Batched KNN: queries [Q, 3] -> (dists [Q, k], idx [Q, k]); with
    ``plane_filter`` [Q] only that plane's points are neighbours."""
    d2 = ((queries[:, None, :] - m.points[None, :, :]) ** 2).sum(dim=-1)
    valid = m.active[None, :]
    if plane_filter is not None:
        valid = valid & (m.plane_id[None, :] == plane_filter[:, None])
    d2 = torch.where(valid, d2, torch.full_like(d2, float("inf")))
    vals, idx = torch.sort(d2, dim=-1, stable=True)
    return torch.sqrt(torch.clamp(vals[:, :k], min=0.0)), idx[:, :k]


def sharded_knn(points_shard, active_shard, queries, k: int, group):
    """KNN over points split into equal contiguous shards over the ranks of
    the process group ``group`` (rank r holds points [r·n, (r+1)·n)):
    points_shard [n, 3], active_shard [n], queries [Q, 3] the same on every
    rank. Each rank takes its shard's k nearest (a stable sort: ties to the
    lower index), ``all_gather`` collects every rank's candidates in rank
    order, and a stable sort of them gives the global k nearest with ties
    to the lower global index, as :func:`knn` orders them on one device.
    Returns (dists [Q, k], global idx [Q, k]), the same on every rank."""
    import torch.distributed as dist

    n = points_shard.shape[0]
    d2 = ((queries[:, None, :] - points_shard[None, :, :]) ** 2).sum(dim=-1)
    d2 = torch.where(active_shard[None, :], d2, torch.full_like(d2, float("inf")))
    kl = min(k, n)
    vals, idx = torch.sort(d2, dim=-1, stable=True)
    cand = torch.stack([vals[:, :kl], (idx[:, :kl] + dist.get_rank(group) * n).to(vals.dtype)])   # [2, Q, kl]
    gathered = [torch.empty_like(cand) for _ in range(dist.get_world_size(group))]
    dist.all_gather(gathered, cand, group=group)
    allc = torch.cat(gathered, dim=-1)                                   # [2, Q, S·kl], rank order
    vals, order = torch.sort(allc[0], dim=-1, stable=True)
    gidx = allc[1].gather(1, order[:, :k]).to(torch.int64)
    return torch.sqrt(torch.clamp(vals[:, :k], min=0.0)), gidx


class PersistentPlaneMap:
    """The replay's map of on-plane points (``run_euroc --use-planes``): each
    frame's triangulated on-plane points are inserted in one fixed-width
    call, and the statistics, KNN queries and the final cloud come from the
    device store (the reference's persistent ikd-tree plane map,
    ROS1Visualizer.cpp:1413-1520). The inserted count stays on the device
    until :meth:`stats` reads it."""

    def __init__(self, capacity: int = 8192, voxel: float = 0.10, frame_batch: int = 128,
                 dtype=torch.float32, device="cuda"):
        self.m = MapBlocks.create(capacity, voxel, dtype, device)
        self.device = self.m.points.device
        self.frame_batch = frame_batch
        self._inserted = torch.zeros((), dtype=torch.int64, device=self.device)

    def add_frame(self, ids, p3, ok, feat_to_plane: dict) -> torch.Tensor:
        """Insert this frame's triangulated on-plane points: ids [N], p3
        [N, 3], ok [N] (host arrays of the whole-track triangulation),
        feat_to_plane maps feature id -> plane id. Returns the inserted
        count (a device scalar)."""
        ids = np.asarray(ids)
        pl = np.asarray([feat_to_plane.get(int(i), -1) for i in ids], np.int32)
        sel = np.nonzero(np.asarray(ok, bool) & (pl >= 0) & (ids >= 0))[0][:self.frame_batch]
        B, n = self.frame_batch, len(sel)
        pts = np.zeros((B, 3))
        pid = np.full(B, -1, np.int32)
        msk = np.zeros(B, bool)
        pts[:n] = np.asarray(p3)[sel]
        pid[:n] = pl[sel]
        msk[:n] = True
        dev = self.device
        self.m, n_ins = insert(self.m, torch.as_tensor(pts, dtype=self.m.points.dtype, device=dev),
                               torch.as_tensor(pid, device=dev), torch.as_tensor(msk, device=dev))
        self._inserted = self._inserted + n_ins
        return n_ins

    def stats(self) -> dict:
        pid = self.m.plane_id.cpu().numpy()
        act = pid >= 0
        return {"n_points": int(act.sum()), "n_planes": int(len(np.unique(pid[act]))),
                "n_inserted_total": int(self._inserted)}

    def query(self, queries, k: int = 5, plane_filter=None):
        """Batched KNN against the store (the TrackPlane z-test form)."""
        q = torch.as_tensor(np.asarray(queries), dtype=self.m.points.dtype, device=self.device)
        pf = None if plane_filter is None else torch.as_tensor(np.asarray(plane_filter), dtype=torch.int32,
                                                               device=self.device)
        return knn(self.m, q, k, pf)

    def cloud(self):
        """(points [n, 3], plane_id [n]) of the live map points (host numpy)."""
        pid = self.m.plane_id.cpu().numpy()
        act = pid >= 0
        return self.m.points.cpu().numpy()[act], pid[act]
