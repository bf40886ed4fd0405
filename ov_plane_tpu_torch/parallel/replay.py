"""Data-parallel batched replay over Monte-Carlo streams (counterpart of
``ov_plane_tpu/parallel/replay.py``).

Each stream's filter is independent, so replay is data parallelism over a
'seq' mesh dimension: every rank runs the batched ``run_sequence`` on its
slab of the streams, and the fleet metric is the only collective. With no
mesh it is the local run.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ov_plane_tpu_torch.convert import NOISY_FIELDS
from ov_plane_tpu_torch.parallel.distributed import _tree_map, axis_slab


def make_mesh(n_devices: int | None = None, axis: str = "seq"):
    """A one-dimension mesh named ``axis`` over every rank of the process
    group (the JAX function's mesh over the first ``n_devices`` devices: a
    ``DeviceMesh`` spans the whole world, so ``n_devices`` must be None or
    the world size)."""
    from ov_plane_tpu_torch.parallel.distributed import global_mesh

    if n_devices not in (None, dist.get_world_size()):
        raise ValueError(f"a mesh spans the {dist.get_world_size()} ranks of the process group, "
                         f"not {n_devices}")
    return global_mesh((axis,))


def shard_leading_axis(tree, mesh, axis: str = "seq"):
    """This rank's contiguous slab (rank order) of the leading dimension of
    every leaf: the JAX function places the whole array sharded over the
    mesh; a rank keeps only its shard."""
    return _tree_map(lambda x: x[axis_slab(mesh, axis, x.shape[0])], tree)


def replicate(tree, mesh):
    """Every leaf whole on every rank: the tree as it is (each rank keeps its
    own copy, as a replicated JAX array has one per device)."""
    return tree


def _stream_slab(sim, B: int, mesh, axis: str):
    """``sim`` with its per-stream fields cut to this rank's B streams: they
    hold every stream of the fleet (the rank's slab is taken), B streams
    already, or one stream shared by all (expanded)."""
    n = sim.imu_w.shape[0]
    if n == B:
        return sim
    if n == 1:
        return sim._replace(**{k: getattr(sim, k).expand(B, *getattr(sim, k).shape[1:]) for k in NOISY_FIELDS})
    if mesh is None:
        raise ValueError(f"the scene holds {n} streams and the states {B}")
    sl = axis_slab(mesh, axis, n)
    if sl.stop - sl.start != B:
        raise ValueError(f"this rank's slab of the scene's {n} streams holds {sl.stop - sl.start}, the states {B}")
    return sim._replace(**{k: getattr(sim, k)[sl] for k in NOISY_FIELDS})


def batched_replay(eng, states_b, banks_b, sim_data, imu_window: int, mesh=None, axis: str = "seq",
                   n_frames: int | None = None):
    """``run_sequence`` of this rank's streams (``states_b``/``banks_b``, its
    slab: ``shard_leading_axis``) over ``sim_data`` (``SimData``: every
    stream of the fleet, this rank's, or one shared stream). Returns (the
    local outputs [B, T, ...], the fleet position RMSE over every stream of
    every rank and every frame): the sum of squared errors and the count
    are summed over the mesh dimension ``axis`` by one ``all_reduce``, so
    every rank holds the same value."""
    from ov_plane_tpu_torch.models.manager import run_sequence

    sim = _stream_slab(sim_data, states_b.imu.shape[0], mesh, axis)
    _, _, outs = run_sequence(eng, states_b, banks_b, sim, imu_window=imu_window, n_frames=n_frames)
    T = outs.p.shape[1]
    err = outs.p.double() - sim.gt_p[1:T + 1].double()
    acc = torch.stack([(err * err).sum(), torch.tensor(float(err.shape[0] * T), dtype=torch.float64,
                                                        device=err.device)])
    if mesh is not None:
        dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=mesh.get_group(axis))
    return outs, torch.sqrt(acc[0] / acc[1])
