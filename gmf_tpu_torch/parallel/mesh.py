"""The ('data', 'model') mesh over a ``torch.distributed`` process group.

Counterpart of ``gmf_tpu/parallel/mesh.py``. gmf_tpu shards one program
over the devices of one process and lets XLA insert the collectives; the
port runs one process per rank, as PyTorch does, and makes the
collectives explicit (``parallel/collectives.py``). Every rank runs the
same program on the same inputs, computes its own slice, and the results
are gathered: the single-host form of JAX's multi-host model.

- 'data' is the primary axis: independent registration pairs per rank.
- 'model' only replicates, as in gmf_tpu: ranks that differ only in
  their 'model' index compute the same slice.

A world is made by ``parallel/launch.py`` (``launch`` spawns N ranks,
``init_world`` joins one started by ``torchrun``). It takes NCCL where
every rank has a card of its own, and gloo on the CPU or where ranks
share a card (NCCL refuses two ranks on one GPU). Gloo moves CUDA tensors
only in all-reduce and broadcast, so such a mesh stages its all-gathers
and ring hops through host copies (``Mesh.staging``); the computation
stays on the card. The choice is made once, from the world's layout, and
recorded on the mesh.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

AXES = ("data", "model")

# the device that ``launch.init_world`` gave this process
_WORLD_DEVICE: Optional[torch.device] = None
# the mesh whose 'data' axis shards the batch of the step in progress
_BATCH_MESH: contextvars.ContextVar = contextvars.ContextVar(
    "gmf_tpu_torch_batch_mesh", default=None)


def world_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


class Mesh:
    """A ('data', 'model') grid of ranks, as seen from this process.

    ``shape``: {"data": n_data, "model": n_model}; ``axis_names``;
    ``ranks``: the global ranks in grid order (data-major); ``rank``: this
    process's global rank; ``index``: its position on each axis (None off
    the mesh); ``device``: where it computes; ``backend``: the world's
    ("nccl", "gloo", or None for the one-rank mesh without a world);
    ``staging``: all-gathers and ring hops go through host copies.
    """

    axis_names = AXES

    def __init__(self, n_data: int, n_model: int, ranks: Sequence[int],
                 rank: int, device: torch.device, backend: Optional[str],
                 groups: Optional[Dict[str, object]] = None):
        self.shape = {"data": int(n_data), "model": int(n_model)}
        self.ranks = tuple(int(r) for r in ranks)
        self.rank = int(rank)
        self.device = torch.device(device)
        self.backend = backend
        self.staging = backend == "gloo" and self.device.type == "cuda"
        self._groups = groups or {}
        if self.rank in self.ranks:
            at = self.ranks.index(self.rank)
            self.index = {"data": at // n_model, "model": at % n_model}
        else:
            self.index = {"data": None, "model": None}

    @property
    def n_data(self) -> int:
        return self.shape["data"]

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["model"]

    def axis_ranks(self, axis: str = "data"):
        """The global ranks along ``axis`` through this rank, in axis
        order."""
        d, m = self.index["data"], self.index["model"]
        n_model = self.shape["model"]
        if axis == "data":
            return [self.ranks[i * n_model + m]
                    for i in range(self.shape["data"])]
        return [self.ranks[d * n_model + i] for i in range(n_model)]

    def group(self, axis: str = "data"):
        """The process group of ``axis`` through this rank (None: the
        whole world)."""
        return self._groups.get(axis)

    def __repr__(self):
        return (f"Mesh(shape={self.shape}, rank={self.rank}, "
                f"device={self.device}, backend={self.backend}, "
                f"staging={self.staging})")


def _default_device():
    if _WORLD_DEVICE is not None:
        return _WORLD_DEVICE
    from gmf_tpu_torch.utils.device import resolve_device

    return resolve_device(None)


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              devices: Optional[Sequence[int]] = None,
              device=None) -> Mesh:
    """A ('data', 'model') mesh over the ranks of the world.

    With defaults all ranks are on 'data'; without a world it is the
    one-rank mesh. ``devices``: the global ranks to take (default every
    rank), the first n_data * n_model of them. ``device``: where this rank
    computes (default the one ``launch.init_world`` chose, else the card).
    Every rank of the world must call this together when the mesh needs
    process groups of its own (n_model > 1, or fewer ranks than the
    world).
    """
    if world_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        backend = dist.get_backend()
    else:
        world, rank, backend = 1, 0, None
    ranks = list(devices) if devices is not None else list(range(world))
    if n_data is None:
        n_data = len(ranks) // n_model
    if n_data * n_model > len(ranks):
        raise AssertionError(
            f"mesh {n_data}x{n_model} needs more than {len(ranks)} devices")
    ranks = ranks[: n_data * n_model]
    groups = {}
    if world_initialized() and len(ranks) > 1:
        if n_model == 1 and ranks == list(range(world)):
            groups["data"] = None  # the world itself
        else:
            for m in range(n_model):
                members = [ranks[d * n_model + m] for d in range(n_data)]
                g = dist.new_group(members)  # every rank takes part
                if rank in members:
                    groups["data"] = g
            for d in range(n_data):
                members = ranks[d * n_model:(d + 1) * n_model]
                g = dist.new_group(members)
                if rank in members:
                    groups["model"] = g
    dev = torch.device(device) if device is not None else _default_device()
    return Mesh(n_data, n_model, ranks, rank, dev, backend, groups)


def local_rows(x, mesh: Mesh, axis: str = "data"):
    """This rank's contiguous share of ``x``'s rows along ``axis``."""
    n = mesh.shape[axis]
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not divide over {n} ranks "
                         f"of {axis!r}")
    per = x.shape[0] // n
    i = mesh.index[axis]
    return x[i * per:(i + 1) * per]


def shard_batch(batch, mesh: Mesh):
    """This rank's slice of every leaf of a batch (a tensor, an array, or
    a dict, list or tuple of them) along its leading axis, on the mesh's
    device. The batch size must divide by n_data, as a device_put over
    the 'data' axis requires."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(v, mesh) for v in batch)
    x = batch if torch.is_tensor(batch) else torch.as_tensor(
        np.asarray(batch))
    return local_rows(x, mesh).to(mesh.device)


def replicate(tree, mesh: Mesh):
    """Rank 0's values of the mesh everywhere: a module's parameters and
    buffers, or the tensors of a dict, list or tuple, broadcast in place
    on the mesh's device. Returns ``tree``."""
    if isinstance(tree, torch.nn.Module):
        leaves = list(tree.parameters()) + list(tree.buffers())
    elif isinstance(tree, dict):
        leaves = list(tree.values())
    elif isinstance(tree, (list, tuple)):
        leaves = list(tree)
    else:
        leaves = [tree]
    if mesh.size > 1 and world_initialized():
        from gmf_tpu_torch.parallel.collectives import broadcast_

        with torch.no_grad():
            for t in leaves:
                if torch.is_tensor(t):
                    broadcast_(t.data, mesh)
    return tree


def data_parallel_shardings(mesh: Mesh):
    """(replicate, shard): the two placements of a data-parallel step, as
    callables of one argument over ``mesh``."""
    return (lambda tree: replicate(tree, mesh),
            lambda batch: shard_batch(batch, mesh))


def process_shard(items: Sequence, process_index: Optional[int] = None,
                  process_count: Optional[int] = None):
    """Per-process strided slice of a host-side work list: each rank of
    the world takes a disjoint share (default: this rank of the world's
    size; the whole list without a world)."""
    if process_index is None:
        process_index = dist.get_rank() if world_initialized() else 0
    if process_count is None:
        process_count = dist.get_world_size() if world_initialized() else 1
    return items[process_index::process_count]


@contextlib.contextmanager
def sharded(mesh: Optional[Mesh]):
    """Run the body as one rank's part of a step whose batch the mesh's
    'data' axis shards: batch norms take their statistics, the losses
    their normalisers, and the model its batch-wide decisions over every
    rank of that axis (``batch_mesh``). A mesh of one 'data' rank, or
    None, changes nothing."""
    token = _BATCH_MESH.set(mesh if mesh is not None and mesh.n_data > 1
                            else None)
    try:
        yield
    finally:
        _BATCH_MESH.reset(token)


def batch_mesh() -> Optional[Mesh]:
    """The mesh of the ``sharded`` step in progress, or None."""
    return _BATCH_MESH.get()
