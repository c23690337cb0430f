"""The collectives of the multi-device paths: the port's counterpart of what
the JAX package writes with ``shard_map`` and ``lax.psum``/``pmax``/
``all_gather``/``ppermute``.

Every rank of a mesh axis computes the same replicated value after a
collective, and every rank then differentiates that same replicated loss.
A replicated parameter's gradient on a rank is its share, and
``train/loops.py`` sums the shares over the mesh. So where a collective's
result feeds replicated work that ends in the loss (the estimate, the
gathered estimates), its backward stays local: the identity for a sum (an
all-reduce there would count the gradient once per rank), this rank's
slice for an all-gather. Where the result feeds work that differs from
rank to rank (the particle block normalised by the global weight mass),
each rank sees only its own part of the cotangent, and the backward sums
the parts over the axis: ``all_reduce_sum_split`` returns the sum twice,
once for each kind of use. The max all-reduce takes
detached values, as JAX's ``stop_gradient`` on ``pmax``
(``particle_sharding.py:158-163``): a stabiliser whose gradient cancels.

The forwards of the max and sum all-reduces and of the all-gather are
PyTorch's functional collectives: the ``_c10d_functional`` ops, each
followed by ``wait_tensor``. They compute what the in-place c10d calls
compute (the same backend collective on a copy of the input), and
``make_fx`` traces them into a graph that ``torch.export`` saves, so a
serving bundle's chunk program holds the particle-sharded step's
collectives (``experiments/export.py``). Such a graph names each
collective's process group by the string ``ProcessGroup.group_name``,
which differs from process to process and from rank to rank; the bundle
records the names it traced and rebinds them on load. The backwards stay
the in-place c10d calls.

The belief relay of the pipeline is a pair of autograd functions: the
forward sends a belief to the next stage and receives from the previous
one, the backward sends the cotangent back. A stage posts its sends and
receives in microbatch order, and autograd runs their backwards in the
reverse of that order on every stage (it runs the ready node created last
first), so the pairs match on both sides without tags.

``counts`` counts each collective by (operation, axis) as it is called:
one gradient all-reduce per data-parallel optimizer step, a max and a sum
all-reduce per particle-sharded step and an all-gather in eval, one relay
per pipeline schedule step. A traced call counts once, at trace time; a
serving bundle adds its program's recorded counts at every call.
"""

from __future__ import annotations

import collections
from typing import List, Sequence

import torch
import torch.distributed as dist

from .mesh import axis_peer, axis_size

counts: collections.Counter = collections.Counter()

WHOLE_MESH = "mesh"


def reset_counts() -> None:
    counts.clear()


def _group(mesh, axis: str):
    """The process group of `mesh`'s axis `axis` (``WHOLE_MESH``: every
    rank of the mesh, which is the world or one axis of a larger mesh)."""
    if axis != WHOLE_MESH:
        return mesh.get_group(axis)
    if whole_mesh_size(mesh) == dist.get_world_size():
        return None
    if mesh.ndim != 1:
        raise ValueError("a collective over a multi-axis mesh smaller than the world")
    return mesh.get_group()


def group_name(mesh, axis: str) -> str:
    """The name of `mesh`'s axis `axis`'s process group, as a traced
    functional collective records it."""
    return (_group(mesh, axis) or dist.group.WORLD).group_name


def _all_reduce(x: torch.Tensor, op: str, name: str) -> torch.Tensor:
    out = torch.ops._c10d_functional.all_reduce(x.contiguous(), op, name)
    return torch.ops._c10d_functional.wait_tensor(out)


def all_reduce_sum_(x: torch.Tensor, mesh, axis: str) -> None:
    """Sum `x` in place over `axis` (no autograd)."""
    counts[("all_reduce_sum", axis)] += 1
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=_group(mesh, axis))


class _AllReduceSumSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, name, group, axis):
        out = _all_reduce(x, "sum", name)
        ctx.group, ctx.axis = group, axis
        return out, out.clone()

    @staticmethod
    def backward(ctx, grad_replicated, grad_sharded):
        grad = grad_sharded.contiguous().clone()
        counts[("all_reduce_sum_grad", ctx.axis)] += 1
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.group)
        return grad + grad_replicated, None, None, None


def all_reduce_sum_split(x: torch.Tensor, mesh, axis: str):
    """The sum of `x` over `axis`, twice: the first for replicated uses
    (identity backward), the second for uses that differ by rank (the
    backward sums its cotangent over the axis). One all-reduce forward."""
    counts[("all_reduce_sum", axis)] += 1
    return _AllReduceSumSplit.apply(x, group_name(mesh, axis), _group(mesh, axis), axis)


def all_reduce_max(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The max of `x` over `axis`, of detached values (the functional
    all-reduce)."""
    counts[("all_reduce_max", axis)] += 1
    return _all_reduce(x.detach(), "max", group_name(mesh, axis))


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, name, dim, size, index):
        out = torch.ops._c10d_functional.all_gather_into_tensor(x.contiguous(), size, name)
        out = torch.ops._c10d_functional.wait_tensor(out)  # (size * x.shape[0], ...)
        ctx.dim, ctx.index, ctx.length = dim, index, x.shape[dim]
        if dim == 0:
            return out
        parts = out.reshape((size,) + tuple(x.shape)).movedim(0, dim)
        return parts.reshape(x.shape[:dim] + (size * x.shape[dim],) + x.shape[dim + 1:])

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.index * ctx.length, ctx.length), None, None, None, None


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """The ranks' `x` along `axis`, concatenated on `dim` in mesh order;
    differentiable (the backward takes this rank's slice)."""
    size = axis_size(mesh, axis)
    if size == 1:
        return x
    counts[("all_gather", axis)] += 1
    index = mesh.get_local_rank(axis)
    return _AllGather.apply(x, group_name(mesh, axis), dim, size, index)


def broadcast_(tensors: Sequence[torch.Tensor], mesh, axis: str, src_index: int) -> None:
    """Overwrite `tensors` on every rank of `axis` with those of the rank
    at coordinate `src_index`, in one message."""
    size = whole_mesh_size(mesh) if axis == WHOLE_MESH else axis_size(mesh, axis)
    if size == 1 or not tensors:
        return
    counts[("broadcast", axis)] += 1
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    if axis == WHOLE_MESH:
        src = int(mesh.mesh.flatten()[src_index])
    else:
        src = axis_peer(mesh, axis, src_index)
    dist.broadcast(flat, src=src, group=_group(mesh, axis))
    offset = 0
    with torch.no_grad():
        for t in tensors:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def whole_mesh_size(mesh) -> int:
    return int(mesh.mesh.numel())


# -- the pipeline's belief relay ---------------------------------------------


class _Send(torch.autograd.Function):
    """Forward: send `x` to `peer`. Returns a zero-size token that the
    caller adds to its loss, so that autograd reaches the backward, which
    receives the cotangent of `x` from `peer`."""

    @staticmethod
    def forward(ctx, x, peer, group):
        dist.send(x.detach().contiguous(), dst=peer, group=group)
        ctx.peer, ctx.group, ctx.shape = peer, group, x.shape
        return x.new_zeros(())

    @staticmethod
    def backward(ctx, grad_token):
        grad = torch.empty(ctx.shape, dtype=grad_token.dtype, device=grad_token.device)
        dist.recv(grad, src=ctx.peer, group=ctx.group)
        return grad, None, None


class _Recv(torch.autograd.Function):
    """Forward: receive a tensor like `like` from `peer`. The backward sends
    its cotangent back. `anchor` (a tensor that requires grad) only puts the
    node on the graph."""

    @staticmethod
    def forward(ctx, anchor, like, peer, group):
        out = torch.empty_like(like)
        dist.recv(out, src=peer, group=group)
        ctx.peer, ctx.group = peer, group
        return out

    @staticmethod
    def backward(ctx, grad):
        dist.send(grad.contiguous(), dst=ctx.peer, group=ctx.group)
        return None, None, None, None


def send_next(x: torch.Tensor, mesh, axis: str, train: bool) -> torch.Tensor:
    """Send `x` to the next stage of `axis`; returns the token (a zero
    tensor) to add to the loss in training."""
    counts[("relay", axis)] += 1
    peer = axis_peer(mesh, axis, mesh.get_local_rank(axis) + 1)
    group = _group(mesh, axis)
    if train:
        return _Send.apply(x, peer, group)
    dist.send(x.contiguous(), dst=peer, group=group)
    return x.new_zeros(())


def recv_prev(like: torch.Tensor, mesh, axis: str, train: bool) -> torch.Tensor:
    """Receive a tensor shaped like `like` from the previous stage of
    `axis`. In training the result is on the graph, and its cotangent goes
    back to that stage."""
    peer = axis_peer(mesh, axis, mesh.get_local_rank(axis) - 1)
    group = _group(mesh, axis)
    if train:
        anchor = like.new_zeros((), requires_grad=True)
        return _Recv.apply(anchor, like, peer, group)
    out = torch.empty_like(like)
    dist.recv(out, src=peer, group=group)
    return out


def flatten(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def unflatten(flat: torch.Tensor, like: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    out, offset = [], 0
    for t in like:
        out.append(flat[offset:offset + t.numel()].view(t.shape))
        offset += t.numel()
    return out

