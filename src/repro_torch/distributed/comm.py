"""Collectives over one axis of a mesh, with a per-rank byte counter.

The port's counterpart of the collectives ``shard_map`` emits in the
reference, and of ``repro.launch.hlo_cost.analyze``'s ``coll_bytes`` and
``coll_breakdown`` for these programs: every call adds its operand bytes
on this rank to ``mesh.counter`` under the reference's HLO kind, so a
placement's traffic per rank reads the same in both packages, with the
host seconds spent in the call (the whole hop on the gloo transports,
which block; the enqueue on NCCL).

* ``ppermute(x, mesh, axis, shift)``: rank i of the axis sends `x` to rank
  i + shift and receives from rank i - shift (``collective-permute``).
* ``psum(x, mesh, axis)``: the sum over the axis (``all-reduce``), as a
  ``torch.autograd.Function`` whose backward hands the cotangent back
  unchanged, as the reference's transpose of ``psum`` does: every rank of
  the axis computes the same loss from the sum, so the gradient of each
  rank's addend is the cotangent itself.  (An all-reduce that all-reduces
  again in its backward would scale the addends' gradients by the axis
  size.)
* ``copy_to(x, mesh, axis)``: Megatron's "f", the identity forward whose
  backward sums the cotangent over the axis.  It stands at the input of
  every column-parallel product: each rank's part of the product sends back
  its share of the input's gradient, and the sum is the whole gradient on
  every rank.  ``psum`` is its "g", after every row-parallel product.
* ``pmax`` (``all-reduce``), ``all_gather`` (``all-gather``, stacked on a
  new leading axis) and ``gather_shards`` (an all-gather along a tensor
  axis whose backward sums the cotangent over the axis and keeps this
  rank's block: the FSDP weight gather).
* ``all_to_all(x, mesh, axis, split_dim, concat_dim)`` (``all-to-all``):
  ``jax.lax.all_to_all(..., tiled=True)``, the expert exchange of the
  MoE's all-to-all dispatch, as a ``torch.autograd.Function`` whose
  backward is the reverse exchange.  It counts max(operand, result) bytes,
  the reference HLO's payload; tiled, the two are equal.

Each call runs on the mesh's transport (``launch.mesh``): NCCL on device
tensors when every rank has a card of its own, gloo on host tensors for CPU
ranks, and gloo with every operand staged through a pinned host buffer when
ranks share a card.  On a mesh with no world behind it (transport
``"none"``: the dry run's ``Mesh(shape, rank, torch.device("meta"),
"none")``) a call moves nothing and calls nothing in ``torch.distributed``:
it takes meta tensors only (on any other it raises, having no values to
return), returns a new meta tensor of its result's shape and dtype, and
counts its bytes and one call as the transports do, backwards included, so
a traced step counts a rank's collectives (``launch.trace_cost``).  An
axis of size 1 moves nothing and counts nothing.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

import torch
import torch.distributed as dist

KINDS = ("collective-permute", "all-reduce", "all-gather", "all-to-all")


@dataclasses.dataclass
class CommCounter:
    """Operand bytes, calls and host seconds on this rank, by the
    reference's HLO kind."""

    bytes: Dict[str, int] = dataclasses.field(default_factory=lambda: dict.fromkeys(KINDS, 0))
    calls: Dict[str, int] = dataclasses.field(default_factory=lambda: dict.fromkeys(KINDS, 0))
    seconds: Dict[str, float] = dataclasses.field(
        default_factory=lambda: dict.fromkeys(KINDS, 0.0))

    def add(self, kind: str, nbytes: int, started: float) -> None:
        self.bytes[kind] += int(nbytes)
        self.calls[kind] += 1
        self.seconds[kind] += time.perf_counter() - started

    def reset(self) -> None:
        for kind in KINDS:
            self.bytes[kind] = 0
            self.calls[kind] = 0
            self.seconds[kind] = 0.0

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes.values())

    @property
    def total_calls(self) -> int:
        return sum(self.calls.values())


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _dry(mesh, x: torch.Tensor) -> bool:
    """Whether `mesh` has no world behind it (its collectives only count).
    Such a call has no values to return, so it takes meta tensors only."""
    if mesh.transport != "none":
        return False
    if x.device.type != "meta":
        raise RuntimeError(f"a mesh with no world moves no values: a collective on it takes "
                           f"meta tensors, not {x.device.type} ones")
    return True


def _to_wire(mesh, x: torch.Tensor) -> torch.Tensor:
    """A private contiguous copy of `x` where the transport reads it: a
    pinned host buffer when ranks share a card, else on `x`'s device."""
    if mesh.staged:
        buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        buf.copy_(x)  # a device-to-host copy waits for the kernels writing x
        return buf
    return x.contiguous().clone()


def _wire_like(mesh, x: torch.Tensor) -> torch.Tensor:
    if mesh.staged:
        return torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def _from_wire(buf: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return buf.to(like.device) if buf.device != like.device else buf


def send(x: torch.Tensor, mesh, dst: int) -> None:
    """Send `x` to world rank `dst` over the mesh's transport.  Uncounted:
    it moves a checkpoint's blocks, which the reference copies to the host
    with no HLO collective."""
    dist.send(_to_wire(mesh, x), dst)


def recv(like: torch.Tensor, mesh, src: int) -> torch.Tensor:
    """A tensor of `like`'s shape and dtype from world rank `src`, where the
    transport delivers it (the host, or this rank's card under NCCL)."""
    buf = _wire_like(mesh, like)
    dist.recv(buf, src)
    return buf


def ppermute(x: torch.Tensor, mesh, axis: str, shift: int) -> torch.Tensor:
    """Rank i of `axis` gets the `x` of rank i - shift (a ring shift)."""
    n = mesh.shape[axis]
    if n == 1:
        return x
    t0 = time.perf_counter()
    if _dry(mesh, x):
        out = torch.empty_like(x, memory_format=torch.contiguous_format)
    else:
        i = mesh.coords[axis]
        ranks = mesh.group_ranks[axis]
        send = _to_wire(mesh, x)
        recv = _wire_like(mesh, x)
        group = mesh.groups[axis]
        ops = [dist.P2POp(dist.isend, send, ranks[(i + shift) % n], group),
               dist.P2POp(dist.irecv, recv, ranks[(i - shift) % n], group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        out = _from_wire(recv, x)
    mesh.counter.add("collective-permute", _nbytes(x), t0)
    return out


def _all_reduce(x: torch.Tensor, mesh, axis: str, op) -> torch.Tensor:
    t0 = time.perf_counter()
    if _dry(mesh, x):
        out = torch.empty_like(x, memory_format=torch.contiguous_format)
    else:
        buf = _to_wire(mesh, x)
        dist.all_reduce(buf, op=op, group=mesh.groups[axis])
        out = _from_wire(buf, x)
    mesh.counter.add("all-reduce", _nbytes(x), t0)
    return out


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _all_reduce(x, mesh, axis, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def psum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Sum of `x` over `axis`; its backward returns the cotangent as is."""
    if mesh.shape[axis] == 1:
        return x
    return _PSum.apply(x, mesh, axis)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous(), ctx.mesh, ctx.axis, dist.ReduceOp.SUM), None, None


def copy_to(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """`x` as it is; its backward sums the cotangent over `axis`."""
    if mesh.shape[axis] == 1:
        return x
    return _CopyTo.apply(x, mesh, axis)


def pmax(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Elementwise max of `x` over `axis` (no gradient)."""
    if mesh.shape[axis] == 1:
        return x
    return _all_reduce(x.detach(), mesh, axis, dist.ReduceOp.MAX)


def all_gather(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Every rank's `x` along `axis`, stacked: (n, *x.shape), in axis order."""
    n = mesh.shape[axis]
    if n == 1:
        return x[None]
    t0 = time.perf_counter()
    if _dry(mesh, x):
        out = x.new_empty((n, *x.shape))
    else:
        send = _to_wire(mesh, x.detach())
        bufs: List[torch.Tensor] = [_wire_like(mesh, x) for _ in range(n)]
        dist.all_gather(bufs, send, group=mesh.groups[axis])
        out = _from_wire(torch.stack(bufs), x)
    mesh.counter.add("all-gather", _nbytes(x), t0)
    return out


class _GatherShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim, ctx.size = mesh, axis, dim, x.shape[dim]
        return torch.cat(list(all_gather(x, mesh, axis)), dim=dim)

    @staticmethod
    def backward(ctx, g):
        total = _all_reduce(g.contiguous(), ctx.mesh, ctx.axis, dist.ReduceOp.SUM)
        i = ctx.mesh.coords[ctx.axis]
        return total.narrow(ctx.dim, i * ctx.size, ctx.size), None, None, None


def gather_shards(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The whole tensor from every rank's block along tensor axis `dim`;
    the backward sums the cotangent over `axis` and keeps this rank's
    block."""
    if mesh.shape[axis] == 1:
        return x
    return _GatherShards.apply(x, mesh, axis, dim)


def _exchange(x: torch.Tensor, mesh, axis: str, split_dim: int, concat_dim: int) -> torch.Tensor:
    """Chunk j of `x` along `split_dim` goes to rank j of `axis`; the chunks
    received from ranks 0..n-1 are concatenated along `concat_dim`."""
    n = mesh.shape[axis]
    if x.shape[split_dim] % n:
        raise ValueError(f"axis {split_dim} of a {tuple(x.shape)} tensor does not split "
                         f"into {n} chunks over {axis}")
    t0 = time.perf_counter()
    front = x.movedim(split_dim, 0)
    chunk = (front.shape[0] // n, *front.shape[1:])
    if _dry(mesh, x):
        recv = x.new_empty((n, *chunk))
    else:
        send = _to_wire(mesh, front.reshape(n, *chunk))
        recv = _wire_like(mesh, send)
        dist.all_to_all_single(recv, send, group=mesh.groups[axis])
        recv = _from_wire(recv, x)
    out = torch.cat([recv[i].movedim(0, split_dim) for i in range(n)], dim=concat_dim)
    mesh.counter.add("all-to-all", max(_nbytes(x), _nbytes(out)), t0)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split_dim, concat_dim):
        ctx.args = (mesh, axis, split_dim, concat_dim)
        return _exchange(x, mesh, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, split_dim, concat_dim = ctx.args
        return _exchange(g.contiguous(), mesh, axis, concat_dim, split_dim), None, None, None, None


def all_to_all(x: torch.Tensor, mesh, axis: str, split_dim: int, concat_dim: int) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axis, split_dim, concat_dim, tiled=True)``:
    `x`'s `split_dim` cut into one chunk a rank of `axis`, chunk j sent to
    rank j, the received chunks concatenated along `concat_dim` in rank
    order.  Its backward sends the cotangent back the same way."""
    if mesh.shape[axis] == 1:
        return x
    return _AllToAll.apply(x, mesh, axis, split_dim, concat_dim)
