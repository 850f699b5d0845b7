"""Logical-axis sharding rules, and the slicing of global tensors into a
rank's block.

The port of ``repro.distributed.sharding``.  Every parameter and key
activation names *logical* axes; a ``ShardingRules`` table maps those to
the mesh's axes, with the reference's defaults:

  batch   -> (pod, data)   data parallelism (pod is an outer pure-DP axis)
  vocab   -> model          TP: embedding/LM-head row sharding
  heads   -> model          TP: attention head sharding
  ff      -> model          TP: MLP hidden sharding
  experts -> model          EP: expert sharding for MoE
  fsdp    -> data           FSDP: weight + optimizer-state sharding
  kv_seq  -> None           SP/CP: set to "data" for context-parallel decode
  tables  -> model          RecSys: embedding-table row sharding

A spec (``pspec``) is a tuple with one entry per tensor axis: None
(replicated), a mesh axis name, or a tuple of mesh axis names (major
first).  Where the reference hands a ``PartitionSpec`` to XLA, the port runs
one program per rank (``launch.mesh``): ``shard`` slices a global tensor to
this rank's block, ``gather`` reassembles it, ``reshard`` moves a block from
one spec to another, and ``constrain`` (``shard_activation``) checks a local
tensor's rank and moves nothing.  ``block_index`` and ``block_shape`` need
the mesh's shape and a rank's coordinates alone, so a ``launch.mesh.Mesh``
record built without a world (``Mesh(shape, rank, torch.device("meta"),
"none")``) answers for any rank: the dry run's use.

An axis that does not divide into its blocks raises ``ValueError``, as the
reference's ``NamedSharding.shard_shape`` and ``jit``'s ``in_shardings``
do (jax 0.9.0 pads no uneven block).
``ShardingRules.sharding`` gives a ``NamedSharding``: the mesh and the spec
in one frozen record, which specs can carry as the reference's do.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Tuple, Union

import torch

from repro_torch.distributed import comm

AxisVal = Union[None, str, tuple]
Spec = Tuple[AxisVal, ...]

DEFAULT_RULES: dict[str, AxisVal] = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,  # activation d_model axis: replicated
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "ff": "model",
    "experts": "model",
    "fsdp": "data",
    "kv_seq": None,  # set to "data" for context-parallel decode
    "tables": "model",
    "layers": None,  # scan-stacked leading axis
    "ssm_heads": "model",
    "conv": None,
}


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec over it (the reference's ``jax.sharding.NamedSharding``
    as a plain record)."""

    mesh: object
    spec: Spec


@dataclasses.dataclass
class ShardingRules:
    mapping: dict[str, AxisVal]
    mesh: Optional[object] = None  # launch.mesh.Mesh

    @staticmethod
    def make(mesh=None, overrides: Optional[Mapping[str, AxisVal]] = None) -> "ShardingRules":
        m = dict(DEFAULT_RULES)
        if overrides:
            m.update(overrides)
        # drop mesh axes that don't exist on this mesh (e.g. "pod" single-pod)
        if mesh is not None:
            def filt(v: AxisVal) -> AxisVal:
                if v is None:
                    return None
                if isinstance(v, str):
                    return v if v in mesh.axis_names else None
                kept = tuple(a for a in v if a in mesh.axis_names)
                return kept if kept else None

            m = {k: filt(v) for k, v in m.items()}
        return ShardingRules(m, mesh)

    def pspec(self, *logical: Optional[str]) -> Spec:
        return logical_pspec(self.mapping, *logical)

    def sharding(self, *logical: Optional[str]) -> Optional[NamedSharding]:
        if self.mesh is None:
            return None
        return NamedSharding(self.mesh, self.pspec(*logical))

    def constrain(self, x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
        return shard_activation(x, self, *logical)

    def axis_size(self, logical: str) -> int:
        """Product of mesh-axis sizes a logical axis maps to (1 if unmapped)."""
        if self.mesh is None:
            return 1
        return spec_size(self.mesh, self.mapping.get(logical))


def logical_pspec(rules: Mapping[str, AxisVal], *logical: Optional[str]) -> Spec:
    """('vocab','fsdp') -> ('model','data') under the default rules."""
    axes = []
    used: set[str] = set()

    def resolve(name: Optional[str]) -> AxisVal:
        if name is None:
            return None
        v = rules.get(name)
        if v is None:
            return None
        # a physical mesh axis may be used at most once in a spec
        if isinstance(v, str):
            return None if v in used else (used.add(v) or v)
        kept = tuple(a for a in v if a not in used)
        used.update(kept)
        return kept if kept else None

    for name in logical:
        axes.append(resolve(name))
    return tuple(axes)


def shard_activation(x: torch.Tensor, rules: ShardingRules, *logical) -> torch.Tensor:
    """A rank's tensor is already its block: check that `logical` names
    every axis of `x`, and move nothing."""
    if len(logical) != x.dim():
        raise ValueError(f"{len(logical)} logical axes for a {x.dim()}-d tensor")
    return x


def entry_axes(entry: AxisVal) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, major first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_axes(spec: Spec) -> Tuple[str, ...]:
    """Every mesh axis a spec shards over."""
    return tuple(a for entry in spec for a in entry_axes(entry))


def spec_size(mesh, entry: AxisVal) -> int:
    """Number of blocks one spec entry cuts its tensor axis into."""
    n = 1
    for a in entry_axes(entry):
        n *= mesh.shape[a]
    return n


def spec_index(mesh, entry: AxisVal, coords: Optional[Mapping[str, int]] = None) -> int:
    """The block along one spec entry (row-major over its axes) of the rank
    at `coords` (this rank's by default)."""
    coords = mesh.coords if coords is None else coords
    i = 0
    for a in entry_axes(entry):
        i = i * mesh.shape[a] + coords[a]
    return i


def block_index(shape, mesh, spec: Spec, coords: Optional[Mapping[str, int]] = None) -> tuple:
    """The slices of a global `shape` that the rank at `coords` (this rank
    by default) holds under `spec`.  Raises where a sharded axis does not
    divide by its blocks."""
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than the {len(shape)}-d tensor")
    index = [slice(0, n) for n in shape]
    for dim, entry in enumerate(spec):
        n = spec_size(mesh, entry)
        if n == 1:
            continue
        if shape[dim] % n:
            raise ValueError(
                f"axis {dim} of a {tuple(shape)} tensor does not divide into "
                f"{n} blocks over {entry}"
            )
        step = shape[dim] // n
        i = spec_index(mesh, entry, coords)
        index[dim] = slice(i * step, (i + 1) * step)
    return tuple(index)


def block_shape(shape, mesh, spec: Spec, coords: Optional[Mapping[str, int]] = None) -> tuple:
    """The shape of the block of a global `shape` that the rank at `coords`
    holds under `spec` (raises as ``block_index``)."""
    return tuple(s.stop - s.start for s in block_index(tuple(shape), mesh, spec, coords))


def shard(x, mesh, spec: Spec):
    """This rank's block of a global tensor (or numpy array, a view of it)
    under `spec`.  Raises where a sharded axis does not divide by its
    blocks."""
    return x[block_index(tuple(x.shape), mesh, spec)]


def gather(x: torch.Tensor, mesh, spec: Spec) -> torch.Tensor:
    """The global tensor from every rank's block under `spec` (an
    all-gather over each sharded axis, minor axis first)."""
    for dim, entry in enumerate(spec):
        for axis in reversed(entry_axes(entry)):
            if mesh.shape[axis] > 1:
                x = torch.cat(list(comm.all_gather(x, mesh, axis)), dim=dim)
    return x


def reshard(x: torch.Tensor, mesh, src: Spec, dst: Spec) -> torch.Tensor:
    """This rank's block under `dst` of the global tensor whose block under
    `src` is `x`: each tensor axis whose entry differs is all-gathered
    over `src`'s axes, then every such axis is cut to this rank's block
    under `dst` (a copy; `x` itself where the specs agree)."""
    n = max(len(src), len(dst), x.dim())
    src_axes = [entry_axes(src[d]) if d < len(src) else () for d in range(n)]
    dst_axes = [entry_axes(dst[d]) if d < len(dst) else () for d in range(n)]
    moved = [d for d in range(n) if src_axes[d] != dst_axes[d]]
    if not moved:
        return x
    for d in moved:
        for axis in reversed(src_axes[d]):
            if mesh.shape[axis] > 1:
                x = torch.cat(list(comm.all_gather(x, mesh, axis)), dim=d)
    index = block_index(tuple(x.shape), mesh, tuple(dst[d] if d in moved and d < len(dst)
                                                    else None for d in range(x.dim())))
    return x[index].clone()
