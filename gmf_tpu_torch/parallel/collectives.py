"""The collectives that XLA inserts for gmf_tpu, made explicit.

gmf_tpu's sharded programs need three kinds of communication, which XLA
derives from the shardings: sums over the mesh (gradients, batch-norm
statistics, loss normalisers), all-gathers of rows (a sharded output
read whole) and one ring hop (``ppermute`` in ring attention). Here each
is a function over a ``Mesh`` axis; on a mesh of one rank each is the
identity.

Where the mesh stages (gloo over CUDA tensors, ``Mesh.staging``), the
all-gather and the hop copy to the host, move there, and copy back.

Autograd, for the two conventions the port's sharded programs use:

- A batch-sharded step (``mesh.sharded``): each rank holds a part of the
  global batch and of the loss. ``all_reduce_sum`` sums with a summing
  backward, as batch-norm statistics need (each rank's rows move every
  rank's normalised outputs); ``replicated_sum`` sums a loss's parts with
  an identity backward, so each rank differentiates only its own part and
  the gradients, summed over the ranks afterwards, are the global one.
- A replicated program with one sharded stage (ring attention): every
  rank holds the full tensors. ``ShardRows`` takes this rank's rows and
  all-gathers the gradient back; ``GatherRows`` all-gathers the rows and
  keeps this rank's rows of the gradient; ``RingHop`` sends a block one
  hop on and its gradient one hop back. Every rank then ends with the
  same full gradient, and nothing is summed afterwards.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from gmf_tpu_torch.parallel.mesh import Mesh, batch_mesh, local_rows


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        y = x.clone()
        dist.all_reduce(y, group=mesh.group(axis))
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone()
        dist.all_reduce(g, group=ctx.mesh.group(ctx.axis))
        return g, None, None


def all_reduce_sum(x: torch.Tensor, mesh: Mesh, axis: str = "data"):
    """The sum of ``x`` over ``axis``, differentiable: the gradient of
    each rank's ``x`` is the sum of every rank's incoming gradient."""
    if mesh.shape[axis] == 1:
        return x
    return _AllReduceSum.apply(x, mesh, axis)


class _ReplicatedSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        y = x.clone()
        dist.all_reduce(y, group=mesh.group(axis))
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def replicated_sum(x: torch.Tensor, mesh: Mesh, axis: str = "data"):
    """The sum of ``x`` over ``axis``; its gradient reaches this rank's
    ``x`` unchanged (module docstring)."""
    if mesh.shape[axis] == 1:
        return x
    return _ReplicatedSum.apply(x, mesh, axis)


def all_true(flag: bool, mesh: Mesh, axis: str = "data") -> bool:
    """True on every rank when ``flag`` is True on every rank of
    ``axis``: a batch-wide decision (an early exit) taken together."""
    if mesh.shape[axis] == 1:
        return bool(flag)
    t = torch.tensor([0 if flag else 1], dtype=torch.int32,
                     device=mesh.device)
    dist.all_reduce(t, group=mesh.group(axis))
    return int(t.item()) == 0


def all_max(value: int, mesh: Mesh, axis: str = "data") -> int:
    """The largest of an integer over ``axis``."""
    if mesh.shape[axis] == 1:
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64, device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group(axis))
    return int(t.item())


def broadcast_(t: torch.Tensor, mesh: Mesh):
    """Overwrite ``t`` in place with the first rank's value of the mesh:
    along 'data', then along 'model'."""
    for axis in ("data", "model"):
        if mesh.shape[axis] > 1:
            dist.broadcast(t, src=mesh.axis_ranks(axis)[0],
                           group=mesh.group(axis))
    return t


def all_gather_rows(x: torch.Tensor, mesh: Mesh, axis: str = "data"):
    """Every rank's ``x`` (all of one shape) stacked along dim 0, in axis
    order. Not differentiable (``GatherRows`` is)."""
    n = mesh.shape[axis]
    if n == 1:
        return x
    src = x.detach().contiguous()
    if mesh.staging:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=mesh.group(axis))
    return torch.cat(parts, 0).to(x.device)


def ring_hop(x: torch.Tensor, mesh: Mesh, axis: str = "data",
             shift: int = 1):
    """``x`` sent ``shift`` places on along the ring of ``axis`` (rank i
    to rank i + shift), and what the rank ``shift`` places back sent
    here: ``jax.lax.ppermute`` with perm [(i, (i + shift) % n)]. The send
    and the receive are posted together (``batch_isend_irecv``): blocking
    sends around a ring can deadlock."""
    n = mesh.shape[axis]
    if n == 1:
        return x
    ring = mesh.axis_ranks(axis)
    i = mesh.index[axis]
    src = x.detach().contiguous()
    if mesh.staging:
        src = src.cpu()
    out = torch.empty_like(src)
    group = mesh.group(axis)
    ops = [dist.P2POp(dist.isend, src, ring[(i + shift) % n], group),
           dist.P2POp(dist.irecv, out, ring[(i - shift) % n], group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out.to(x.device)


class RingHop(torch.autograd.Function):
    """``ring_hop`` with its adjoint as the backward: the gradient of the
    block that arrived here goes back to the rank that sent it."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return ring_hop(x, mesh, axis, 1)

    @staticmethod
    def backward(ctx, grad):
        return ring_hop(grad, ctx.mesh, ctx.axis, -1), None, None


class ShardRows(torch.autograd.Function):
    """This rank's rows of a tensor every rank holds whole; the backward
    all-gathers every rank's gradient of its rows, so that each rank has
    the gradient of the whole tensor."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return local_rows(x, mesh, axis).clone()

    @staticmethod
    def backward(ctx, grad):
        return all_gather_rows(grad, ctx.mesh, ctx.axis), None, None


class GatherRows(torch.autograd.Function):
    """Every rank's rows stacked, on every rank; the backward keeps this
    rank's rows of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return all_gather_rows(x, mesh, axis)

    @staticmethod
    def backward(ctx, grad):
        return local_rows(grad, ctx.mesh, ctx.axis).contiguous(), None, None


def shard_rows(x, mesh: Mesh, axis: str = "data"):
    if mesh.shape[axis] == 1:
        return x
    return ShardRows.apply(x, mesh, axis)


def gather_rows(x, mesh: Mesh, axis: str = "data"):
    if mesh.shape[axis] == 1:
        return x
    return GatherRows.apply(x, mesh, axis)


def hop(x, mesh: Mesh, axis: str = "data"):
    if mesh.shape[axis] == 1:
        return x
    return RingHop.apply(x, mesh, axis)


# -- a batch-sharded step's sums (module docstring) ------------------------


def batch_sum(x: torch.Tensor):
    """``x`` summed over the ranks of the ``sharded`` step in progress
    (identity backward), or ``x`` outside one."""
    mesh = batch_mesh()
    return x if mesh is None else replicated_sum(x, mesh)


def batch_rows(n: int) -> int:
    """The global batch of a ``sharded`` step whose local batch is
    ``n`` rows (``n`` outside one)."""
    mesh = batch_mesh()
    return n if mesh is None else n * mesh.n_data


def batch_mean(x: torch.Tensor):
    """The mean of the per-pair values ``x`` [B] over the global batch
    (``x.mean()`` outside a ``sharded`` step)."""
    if batch_mesh() is None:
        return x.mean()
    return batch_sum(x.sum()) / batch_rows(x.shape[0])


def batch_all(flag: bool) -> bool:
    """``flag`` on every rank of the ``sharded`` step in progress."""
    mesh = batch_mesh()
    return bool(flag) if mesh is None else all_true(flag, mesh)
