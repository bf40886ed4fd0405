"""Multi-process wiring over ``torch.distributed`` (counterpart of
``ov_plane_tpu/parallel/distributed.py``).

The reference is a single-process system with no compute communication;
this layer is new architecture: one process per rank, joined into one
process group, and a ``DeviceMesh`` whose named dimensions play the JAX
mesh's axes ('seq' or 'dp' over streams, 'sp' over the rows of one
update). PyTorch has no global sharded array: a rank holds its own slab of
every batched tensor, and the only communication is the explicit
collectives of ``parallel.replay.batched_replay`` (the fleet RMSE),
``parallel.schur.sharded_compress`` and ``frontend.map_blocks.sharded_knn``.

The backend is the caller's choice: 'gloo' for CPU tensors, and on one card
for CUDA tensors of several ranks (NCCL refuses two ranks on one device;
PyTorch's gloo runs ``all_reduce`` and ``all_gather`` on CUDA tensors),
'nccl' when each rank has a card of its own. Nothing tells a process of its
cluster: the address, world size and rank are arguments.

The mesh that ``models.msckf.msckf_update`` looks its ``shard_axis`` up in
is this module's current mesh (:func:`set_mesh`; :func:`global_mesh` sets
it), as the JAX update reads the ambient mesh of ``jax.set_mesh``.
"""

from __future__ import annotations

import datetime

import numpy as np
import torch
import torch.distributed as dist

_MESH = None


def init_process(backend: str, init_method: str | None = None, world_size: int | None = None,
                 rank: int | None = None, coordinator: str | None = None, timeout_s: float = 300.0) -> None:
    """Join (or create) the process group: ``backend`` 'gloo' or 'nccl';
    ``init_method`` a URL such as 'tcp://localhost:PORT', or ``coordinator``
    'host:port' (the JAX argument's form). A collective that waits longer
    than ``timeout_s`` raises instead of hanging."""
    if coordinator is not None:
        init_method = f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))


def set_mesh(mesh) -> None:
    """Make ``mesh`` (a ``DeviceMesh``, or None) the process's current mesh."""
    global _MESH
    _MESH = mesh


def global_mesh(axes=("seq",), shape=None, device_type: str | None = None):
    """A mesh over every rank of the world, its dimensions named ``axes``
    (a name or a tuple), of ``shape`` (default: the whole world on one
    dimension), on ``device_type`` (default: 'cuda' under NCCL, else
    'cpu': a gloo mesh carries CUDA tensors as well). It becomes the
    current mesh."""
    from torch.distributed.device_mesh import init_device_mesh

    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    shape = (dist.get_world_size(),) if shape is None else tuple(shape)
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    mesh = init_device_mesh(device_type, shape, mesh_dim_names=axes)
    set_mesh(mesh)
    return mesh


def axis_group(axis: str):
    """The process group of the current mesh's dimension ``axis``; raises
    when no process group or no mesh with that dimension exists."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(f"shard axis {axis!r}: no torch.distributed process group is initialized "
                           "(parallel.distributed.init_process)")
    if _MESH is None or axis not in (_MESH.mesh_dim_names or ()):
        raise RuntimeError(f"shard axis {axis!r}: the current mesh has no such dimension "
                           f"({None if _MESH is None else _MESH.mesh_dim_names}; parallel.distributed.set_mesh)")
    return _MESH.get_group(axis)


def axis_slab(mesh, axis: str, n: int) -> slice:
    """This rank's contiguous slab of a leading dimension of ``n`` over the
    mesh dimension ``axis`` (``n`` must divide by its size)."""
    size, pos = mesh.size(mesh.mesh_dim_names.index(axis)), mesh.get_local_rank(axis)
    if n % size:
        raise ValueError(f"a leading dimension of {n} does not divide over the {size} ranks of {axis!r}")
    m = n // size
    return slice(pos * m, (pos + 1) * m)


def _tree_map(fn, tree):
    """``fn`` on every tensor or array leaf of a TensorTree, NamedTuple, dict or leaf."""
    from ov_plane_tpu_torch.state.vio_state import TensorTree

    if isinstance(tree, TensorTree):
        return tree.replace(**{k: fn(v) for k, v in tree.tensors().items()})
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return tree._replace(**{k: fn(v) for k, v in tree._asdict().items()
                                if isinstance(v, (torch.Tensor, np.ndarray))})
    if isinstance(tree, dict):
        return {k: fn(v) for k, v in tree.items()}
    return fn(tree)


def _as_tensors(tree, device):
    return _tree_map(lambda x: torch.as_tensor(x) if device is None else torch.as_tensor(x).to(device), tree)


def process_batch_to_global(tree, mesh, axis: str = "seq", device=None):
    """The JAX function assembles every process's local slab into one global
    array sharded over ``axis``. PyTorch has no global array: a rank's slab
    (its ``axis_slab`` of the global batch, in rank order) *is* its shard,
    so every leaf is returned as a tensor on ``device`` (default: where it
    lies)."""
    return _as_tensors(tree, device)


def replicate_from_local(tree, mesh, device=None):
    """Identical data on every rank (a deterministic measurement stream): the
    JAX function makes fully replicated global arrays of it; here every rank
    keeps its own copy, returned as tensors on ``device``."""
    return _as_tensors(tree, device)
