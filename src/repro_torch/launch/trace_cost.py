"""Per-rank cost of one call, traced op by op on meta tensors: the port of
``repro.launch.hlo_cost``.

The reference walks a compiled program's HLO; the port's programs are
eager, so ``analyze(fn, args)`` runs ``fn`` once, on tensors of the meta
device (shapes and dtypes, no storage, no arithmetic), under one
``TorchDispatchMode`` that sees every ATen op the call dispatches, its
backward's included (autograd runs its engine under the same mode), and
counts, per op:

  flops       : matrix products only (``mm``, ``addmm``, ``bmm``,
                ``baddbmm``, ``_scaled_mm`` and the fused attentions), by
                ``torch.utils.flop_counter``'s formulas: 2 * numel(result) *
                contraction, the reference's dot convention.  Convolutions
                are counted apart (``conv_flops``), as the reference's dot
                count leaves them out; ``flops + conv_flops`` is what
                ``FlopCounterMode`` totals.
  trans       : transcendentals, one a result element of the reference's
                ``_TRANS_OPS`` (exp, log, tanh, rsqrt, sqrt, pow, logistic,
                sin, cos, log1p, expm1) and of the ATen ops built on them
                (silu, the softmaxes, logsumexp: one each; softplus: two).
  hbm bytes   : the reference's fusion convention.  Operands plus result
                for MATERIALIZING ops only: matrix products and
                convolutions, reductions (sums, means, extrema, norms,
                softmaxes, scans), sort and top-k, ``cat``/``stack``;
                gathers (index, ``index_select``, ``gather``, embedding)
                2 * result + the indices, scatters (``index_put``,
                ``scatter``, ``index_add``, the embedding's backward)
                3 * the updates; copies and layout ops (``clone``,
                ``copy_`` into a buffer or a slice of one, pads, flips,
                rolls, repeats) 2 * result.  Pure elementwise ops
                (arithmetic, ``where``, dtype casts, fills) are free: on a
                TPU they fuse into their neighbours.  Views are free: in
                eager PyTorch they move nothing.  A collective adds its
                payload, as in the reference (it touches HBM).
  collectives : what the mesh's ``CommCounter`` gains in the call: on a
                dry mesh (``distributed.comm``) each collective counts
                its bytes under the reference's HLO kind and moves nothing.
  peak bytes  : the highest total of live storages on the arguments'
                device during the call, starting from the arguments: each
                storage counted once (views share it), rounded up to the
                CUDA caching allocator's 512-byte block; a storage lives
                until its last reference dies (a weakref finalizer on it),
                so autograd's saved tensors count while they are held, and
                an in-place update (the optimizers') adds no storage.
                A layout's bookkeeping (optimizer-state specs, cache
                shapes) works on ``ShapeDtype`` records and allocates
                nothing.

The reference multiplies a while loop's body by its ``known_trip_count``;
the port's loops (microbatches, layers, sequence blocks, MoE blocks) run
in Python, so each trip dispatches its ops again and is counted as it
runs.  What the trace cannot see is what an op allocates inside its own
kernel (a library's workspace) and the allocator's fragmentation; the
numbers are counts over shapes, not measurements.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Callable, Dict

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

BLOCK = 512  # bytes: the CUDA caching allocator rounds every block up to this

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_CONV = {"convolution", "_convolution", "cudnn_convolution", "convolution_overrideable",
         "_slow_conv2d_forward", "convolution_backward"}
_TRANS = {"exp": 1, "log": 1, "tanh": 1, "rsqrt": 1, "sqrt": 1, "pow": 1, "sigmoid": 1,
          "sin": 1, "cos": 1, "log1p": 1, "expm1": 1, "exp2": 1, "log2": 1,
          "silu": 1, "silu_backward": 1, "_softmax": 1, "_log_softmax": 1,
          "logsumexp": 1, "softplus": 2,
          "_foreach_exp": 1, "_foreach_sqrt": 1, "_foreach_log": 1, "_foreach_pow": 1}
_REDUCE = {"sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin", "prod", "var",
           "var_mean", "std", "std_mean", "norm", "linalg_vector_norm", "_foreach_norm",
           "logsumexp", "cumsum", "cumprod", "_softmax", "_log_softmax",
           "_softmax_backward_data", "_log_softmax_backward_data", "any", "all",
           "nll_loss_forward", "nll_loss_backward", "sort", "topk", "argsort", "kthvalue",
           "cat", "stack"}
_GATHER = {"index", "index_select", "gather", "embedding", "take"}
_SCATTER = {"index_put": 2, "index_put_": 2, "_index_put_impl_": 2, "scatter": 3,
            "scatter_": 3, "scatter_add": 3, "scatter_add_": 3, "scatter_reduce": 3,
            "index_add": 3, "index_add_": 3, "index_copy": 3, "index_copy_": 3,
            "embedding_dense_backward": 0}  # the argument that holds the updates
_LAYOUT = {"clone", "copy_", "copy", "constant_pad_nd", "reflection_pad1d", "flip", "roll",
           "repeat", "_reshape_copy", "expand_copy", "permute_copy", "transpose_copy"}


def _round(nbytes: int) -> int:
    return -(-nbytes // BLOCK) * BLOCK


def _tensors(tree) -> list:
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _leaves(tree) -> list:
    """The tensors of a call's arguments or result: nested dicts, lists and
    tuples of tensors, and modules (their parameters)."""
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


@dataclasses.dataclass
class Cost:
    """The reference's ``hlo_cost.Cost`` fields, and what the trace adds:
    collective calls by kind, convolutions' FLOPs apart, the peak of live
    bytes, the argument bytes it started from, the outputs' bytes and how
    many of them are arguments updated in place, and the ops dispatched."""

    flops: float = 0.0
    trans: float = 0.0
    hbm_bytes: float = 0.0
    coll_bytes: float = 0.0
    coll_breakdown: Dict[str, float] = dataclasses.field(
        default_factory=lambda: dict.fromkeys(COLLECTIVES, 0.0))
    coll_calls: Dict[str, int] = dataclasses.field(
        default_factory=lambda: dict.fromkeys(COLLECTIVES, 0))
    conv_flops: float = 0.0
    peak_bytes: int = 0
    arg_bytes: int = 0
    out_bytes: int = 0
    alias_bytes: int = 0
    ops: int = 0


class _NoKey(Exception):
    """An op's arguments that the memo cannot key (a tensor off meta, an
    unhashable value)."""


def _key(x):
    """A hashable stand-in for an op's argument: a meta tensor's shape,
    strides and dtype; a sequence's keys; a scalar with its type."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "meta":
            raise _NoKey
        return (x.shape, x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        return tuple([_key(v) for v in x])
    if x is None or isinstance(x, (int, float, bool, torch.dtype, torch.device)):
        return (type(x), x)
    try:
        hash(x)
    except TypeError:
        raise _NoKey from None
    return (type(x), x)


def _fresh(func) -> bool:
    """Whether `func` returns new tensors only (no view of, and no write
    into, an argument)."""
    schema = func._schema
    return not schema.is_mutable and all(r.alias_info is None for r in schema.returns)


def _in_place_values_only(func) -> bool:
    """Whether `func` writes values into its arguments and changes no
    shape: an in-place pointwise op, a fill or a copy, a ``_foreach_``
    update."""
    name = func.overloadpacket.__name__
    if not name.endswith("_"):
        return False
    return (torch.Tag.pointwise in func.tags or name in ("copy_", "fill_", "zero_",
                                                           "masked_fill_")
            or name.startswith("_foreach_"))


class _CostMode(TorchDispatchMode):
    """Counts every dispatched op into `cost` and follows the live storages
    on `device_type` (``analyze`` says how).

    On meta tensors an op's result depends on its arguments' shapes,
    strides and dtypes alone, and PyTorch computes it for most ops in
    Python (``torch._refs``), ~0.1 ms an op.  So the mode keeps a memo: an
    op that returns new tensors is run once for each key of its arguments
    (``_key``), and afterwards its results are new empty tensors of the
    remembered shapes, strides and dtypes, with the remembered counts; an
    in-place op that writes values only returns its argument unrun.  Ops
    that return views, change shapes in place, or touch a tensor off meta
    always run: on the host their values may steer the program."""

    def __init__(self, cost: Cost, device_type: str):
        super().__init__()
        self.cost = cost
        self.device_type = device_type
        self.memo_on = device_type == "meta"
        self.memo: Dict[Any, Any] = {}
        self.kinds: Dict[Any, str] = {}  # op -> "fresh", "in place" or "run"
        self.live_ids: Dict[int, int] = {}  # id(storage) -> its rounded bytes
        self.live = 0
        self.finalizers: list = []

    def track(self, tensors) -> None:
        for t in tensors:
            if t.device.type != self.device_type:
                continue
            st = t.untyped_storage()
            key = id(st)
            if key in self.live_ids:
                continue
            size = _round(st.nbytes())
            self.live_ids[key] = size
            self.live += size
            self.finalizers.append(weakref.finalize(st, self._free, key))
        self.cost.peak_bytes = max(self.cost.peak_bytes, self.live)

    def _free(self, key: int) -> None:
        self.live -= self.live_ids.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.memo_on:
            out = self._memoized(func, args, kwargs)
            if out is not _MISS:
                return out
        out = func(*args, **kwargs)
        self._add(self._count(func, args, kwargs, out))
        self.track(_tensors(out))
        return out

    def _memoized(self, func, args, kwargs):
        """`func`'s result from the memo, or _MISS where it must run."""
        kind = self.kinds.get(func)
        if kind is None:
            kind = self.kinds[func] = ("fresh" if _fresh(func) else
                                       "in place" if _in_place_values_only(func) else "run")
        if kind == "run":
            return _MISS
        fresh = kind == "fresh"
        try:
            key = (func, _key(args), _key(tuple(kwargs.items())))
        except _NoKey:
            return _MISS
        if not fresh:  # values written in place: the op returns its first argument
            if key not in self.memo:
                self.memo[key] = self._count(func, args, kwargs, args[0])
            self._add(self.memo[key])
            return args[0] if func._schema.returns else None
        hit = self.memo.get(key)
        if hit is _RUN:
            return _MISS
        if hit is None:
            out = func(*args, **kwargs)
            leaves, spec = pytree.tree_flatten(out)
            inputs = {id(t.untyped_storage()) for t in _tensors((args, kwargs))}
            if not all(isinstance(t, torch.Tensor) and t.device.type == "meta"
                       and id(t.untyped_storage()) not in inputs for t in leaves):
                # a result off meta, or a view its schema does not declare
                # (``_unsafe_view``): run it every time
                self.memo[key] = _RUN
                self._add(self._count(func, args, kwargs, out))
                self.track(_tensors(out))
                return out
            metas = [(t.shape, t.stride(), t.dtype) for t in leaves]
            hit = self.memo[key] = (self._count(func, args, kwargs, out), spec, metas)
        else:
            counts, spec, metas = hit
            out = pytree.tree_unflatten(
                [torch.empty_strided(shape, stride, dtype=dtype, device="meta")
                 for shape, stride, dtype in metas], spec)
        self._add(hit[0])
        self.track(pytree.tree_leaves(out))
        return out

    def _add(self, counts: tuple) -> None:
        c = self.cost
        c.ops += 1
        c.flops += counts[0]
        c.conv_flops += counts[1]
        c.hbm_bytes += counts[2]
        c.trans += counts[3]

    @staticmethod
    def _count(func, args, kwargs, out) -> tuple:
        """(flops, conv flops, hbm bytes, transcendentals) of one op."""
        packet = func.overloadpacket
        name = packet.__name__
        flops = conv = hbm = trans = 0
        if packet in flop_registry:
            n = flop_registry[packet](*args, **kwargs, out_val=out)
            if name in _CONV:
                conv = n
            else:
                flops = n
            hbm = _bytes((args, kwargs)) + _bytes(out)
        elif name in _REDUCE:
            hbm = _bytes((args, kwargs)) + _bytes(out)
        elif name in _GATHER:
            idx = [t for t in _tensors((args, kwargs)) if not t.is_floating_point()]
            hbm = 2 * _bytes(out) + _bytes(idx)
        elif name in _SCATTER:
            hbm = 3 * _bytes(args[_SCATTER[name]])
        elif name in _LAYOUT:
            hbm = 2 * _bytes(out)
        if name in _TRANS:
            trans = _TRANS[name] * sum(t.numel() for t in _tensors(out))
        return flops, conv, hbm, trans


_MISS = object()
_RUN = object()  # a memo entry: the op runs every time


def analyze(fn: Callable, args: tuple, counter: Any = None) -> Cost:
    """The ``Cost`` of one call of ``fn(*args)`` under the counting mode.
    The arguments' device (the first tensor's: meta for a dry run) is the
    device whose live storages make the peak; `counter` is the mesh's
    ``CommCounter``, whose gain in the call gives the collectives."""
    cost = Cost()
    arg_tensors = _leaves(args)
    device_type = arg_tensors[0].device.type if arg_tensors else "meta"
    before = ({k: (counter.bytes[k], counter.calls[k]) for k in counter.bytes}
              if counter is not None else {})
    mode = _CostMode(cost, device_type)
    arg_ids = {id(t.untyped_storage()) for t in arg_tensors if t.device.type == device_type}
    try:
        mode.track(arg_tensors)
        cost.arg_bytes = mode.live
        with mode:
            out = fn(*args)
        seen = set()
        for t in _leaves(out):
            st = t.untyped_storage()
            if t.device.type != device_type or id(st) in seen:
                continue
            seen.add(id(st))
            cost.out_bytes += st.nbytes()
            if id(st) in arg_ids:
                cost.alias_bytes += st.nbytes()
    finally:
        for f in mode.finalizers:
            f.detach()
    if counter is not None:
        for k, (b0, n0) in before.items():
            cost.coll_breakdown[k] += counter.bytes[k] - b0
            cost.coll_calls[k] += counter.calls[k] - n0
        cost.coll_bytes = sum(cost.coll_breakdown.values())
        cost.hbm_bytes += cost.coll_bytes
    return cost
