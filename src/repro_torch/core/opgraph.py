"""Operator-graph IR for the ETL Transform, with placement-aware lowering.

The port of ``repro.core.opgraph``.  The Transform (encoded pages ->
train-ready mini-batch) is declared ONCE as a graph of typed operators over
*column families* — independent groups of columns that flow through their
own decode->transform chain:

    family    pages consumed     chain                              batch key
    dense     dense_words        Decode(bytesplit) -> LogNorm       dense
    sparse    sparse_words       Decode(bitpack)   -> SigridHash    multi_hot_ids
    gen       gen_words [1]      Decode -> Bucketize -> SigridHash  one_hot_ids
    lengths   length_words       Decode(lengths)                    lengths
    labels    label_words        Decode(labels)                     labels

    [1] gen_words = the sourced dense planes (``spec.generated_source``),
        bound by ``prepare_env`` so the family is independent of `dense`.

A *placement* assigns each family to ``"isp"`` (the in-storage unit) or
``"host"`` (a CPU-style preprocessing server).  ``lower`` turns graph +
placement into an ordered stage list:

* an ISP-placed chain whose kind tuple appears in
  ``repro_torch.kernels.FUSED_KERNELS`` lowers to ONE fused CUDA kernel —
  one read of encoded bytes, one write of tensors (the PreSto pipeline);
* a host-placed chain lowers to one stage per operator, each a standalone
  CUDA kernel from ``repro_torch.kernels.OP_KERNELS`` (the Disagg-style
  multi-pass baseline, also what the per-stage latency breakdown times).

On one device both run on the card: the placement decides the lowering,
not where the bytes go (this package has no meshed hops for host
families).  The lowered stages (names, kinds, wiring) are the JAX
package's, so a plan's ``structural_hash`` equals the reference's for the
same spec and placement.  The spec's seeds, table sizes and padded
boundaries go to the device once, at lowering.

The glue outside the kernels stays plain PyTorch on the device, as the JAX
package keeps it outside any Pallas kernel: the ``gen_words`` gather, the
labels bitcast and the ``form_batch`` transposes.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import time
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.common.util import resolve_device, span
from repro_torch.core.spec import TransformSpec
from repro_torch.kernels import FUSED_KERNELS, OP_KERNELS, ROW_LOCAL_KINDS
from repro_torch.kernels import ops as K

ISP = "isp"
HOST = "host"
FAMILIES = ("dense", "sparse", "gen", "lengths", "labels")

# column family -> page values consumed / mini-batch keys produced.
FAMILY_PAGE_VALUES: Dict[str, Tuple[str, ...]] = {
    "dense": ("dense_words",),
    "sparse": ("sparse_words",),
    "gen": ("gen_words",),
    "lengths": ("length_words",),
    "labels": ("label_words",),
}
FAMILY_BATCH_KEYS: Dict[str, Tuple[str, ...]] = {
    "dense": ("dense",),
    "sparse": ("multi_hot_ids",),
    "gen": ("one_hot_ids",),
    "lengths": ("lengths",),
    "labels": ("labels",),
}


# ---------------------------------------------------------------------------
# Nodes


@dataclasses.dataclass(frozen=True)
class OpNode:
    """One typed operator: consumes named values, produces one named value."""

    name: str
    family: str
    inputs: Tuple[str, ...]
    output: str

    @property
    def kind(self) -> str:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Decode(OpNode):
    encoding: str = "bytesplit"  # bytesplit | bitpack | lengths | labels
    width: int = 0  # bits per value (bitpack / lengths)

    @property
    def kind(self) -> str:
        return f"decode.{self.encoding}"


@dataclasses.dataclass(frozen=True)
class Bucketize(OpNode):
    @property
    def kind(self) -> str:
        return "bucketize"


@dataclasses.dataclass(frozen=True)
class SigridHash(OpNode):
    table: str = "sparse"  # which (seeds, max) bank of the spec: sparse | gen

    @property
    def kind(self) -> str:
        return "sigridhash"


@dataclasses.dataclass(frozen=True)
class LogNorm(OpNode):
    @property
    def kind(self) -> str:
        return "lognorm"


@dataclasses.dataclass(frozen=True)
class FormBatch(OpNode):
    @property
    def kind(self) -> str:
        return "formbatch"


# ---------------------------------------------------------------------------
# Graph


@dataclasses.dataclass(frozen=True)
class OpGraph:
    """Nodes + the page values bound externally; edges are value names."""

    nodes: Tuple[OpNode, ...]
    page_inputs: Tuple[str, ...]

    def __post_init__(self):
        produced = set(self.page_inputs)
        for n in self.nodes:  # nodes must already be topo-ordered
            missing = [i for i in n.inputs if i not in produced]
            if missing:
                raise ValueError(f"node {n.name} consumes unknown values {missing}")
            if n.output in produced:
                raise ValueError(f"value {n.output} produced twice")
            produced.add(n.output)

    def node(self, name: str) -> OpNode:
        for n in self.nodes:
            if n.name == name:
                return n
        raise KeyError(name)

    def family_chain(self, family: str) -> Tuple[OpNode, ...]:
        """The family's operators, in dependency order (graph order)."""
        return tuple(n for n in self.nodes if n.family == family)

    @property
    def families(self) -> Tuple[str, ...]:
        seen: List[str] = []
        for n in self.nodes:
            if n.family not in seen and not isinstance(n, FormBatch):
                seen.append(n.family)
        return tuple(seen)


def build_transform_graph(spec: TransformSpec) -> OpGraph:
    """The standard RecSys ETL Transform (paper Fig. 1) as an OpGraph."""
    cfg = spec.cfg
    nodes = (
        Decode("decode_dense", "dense", ("dense_words",), "dense_raw",
               encoding="bytesplit"),
        LogNorm("lognorm_dense", "dense", ("dense_raw",), "dense_norm"),
        Decode("decode_sparse", "sparse", ("sparse_words",), "sparse_raw",
               encoding="bitpack", width=cfg.id_width),
        SigridHash("hash_sparse", "sparse", ("sparse_raw",), "sparse_hashed",
                   table="sparse"),
        Decode("decode_gen", "gen", ("gen_words",), "gen_raw",
               encoding="bytesplit"),
        Bucketize("bucketize_gen", "gen", ("gen_raw",), "bucket_ids"),
        SigridHash("hash_gen", "gen", ("bucket_ids",), "gen_hashed",
                   table="gen"),
        Decode("decode_lengths", "lengths", ("length_words",), "lengths_i32",
               encoding="lengths", width=cfg.len_width),
        Decode("decode_labels", "labels", ("label_words",), "labels_f32",
               encoding="labels"),
        FormBatch(
            "form_batch", "batch",
            ("dense_norm", "sparse_hashed", "lengths_i32", "labels_f32",
             "gen_hashed"),
            "minibatch",
        ),
    )
    return OpGraph(
        nodes=nodes,
        page_inputs=("dense_words", "sparse_words", "length_words",
                     "label_words", "gen_words"),
    )


def prepare_env(pages: Dict[str, torch.Tensor], gen_index: torch.Tensor) -> Dict[str, Any]:
    """Bind graph page inputs from the staged page tensors.

    ``gen_words`` (the generated features' source planes) is a gather of
    dense pages by ``gen_index`` (``spec.generated_source`` on the pages'
    device) — computed here so the gen family never depends on the dense
    family's placement.  The gather runs in the span ``opgraph.gen_words``."""
    env = dict(pages)
    with span("opgraph.gen_words"):
        env["gen_words"] = pages["dense_words"].index_select(0, gen_index)
    return env


# ---------------------------------------------------------------------------
# Placement resolution


def resolve_placements(mode, spec: TransformSpec, rows: int | None = None) -> Dict[str, str]:
    """mode -> {family: "isp"|"host"}.

    str modes: "fused"/"presto"/"isp" (all ISP), "unfused"/"disagg"/"host"
    (all host), or "hybrid" (per-family choice by the cost model for
    partitions of `rows`, default the spec's).  A dict is taken verbatim
    (validated)."""
    if isinstance(mode, dict):
        unknown = set(mode) - set(FAMILIES)
        if unknown:
            raise ValueError(f"unknown column families {sorted(unknown)}")
        bad = {f: p for f, p in mode.items() if p not in (ISP, HOST)}
        if bad:
            raise ValueError(f"placements must be 'isp' or 'host', got {bad}")
        out = {f: ISP for f in FAMILIES}
        out.update(mode)
        return out
    if mode in ("fused", "presto", ISP):
        return {f: ISP for f in FAMILIES}
    if mode in ("unfused", "disagg", HOST):
        return {f: HOST for f in FAMILIES}
    if mode == "hybrid":
        from repro_torch.core.costmodel import choose_placement  # lazy: avoids cycle

        return choose_placement(spec, rows)
    raise ValueError(f"unknown mode/placement {mode!r}")


# ---------------------------------------------------------------------------
# Byte accounting


def family_page_bytes(spec: TransformSpec, rows: int) -> Dict[str, int]:
    """Encoded bytes each family reads, per partition of `rows`.

    Dedup datasets (``cfg.dup_factor > 1``) store sparse/length pages at
    unique-block geometry, plus a 4-byte-per-sample refs page charged to the
    sparse family."""
    cfg = spec.cfg
    d = max(int(cfg.dup_factor), 1)
    u = rows // d
    return {
        "dense": cfg.n_dense * rows * 4,  # bytesplit: 4 plane bytes / value
        "sparse": cfg.n_sparse * (u * cfg.max_sparse_len // 32)
        * cfg.id_width * 4
        + (rows * 4 if d > 1 else 0),
        "gen": cfg.n_generated * rows * 4,  # sourced dense planes
        "lengths": cfg.n_sparse * (u // 32) * cfg.len_width * 4,
        "labels": rows * 4,
    }


def family_batch_bytes(spec: TransformSpec, rows: int) -> Dict[str, int]:
    """Train-ready tensor bytes each family writes, per partition of `rows`."""
    cfg = spec.cfg
    return {
        "dense": rows * cfg.n_dense * 4,
        "sparse": rows * cfg.n_sparse * cfg.max_sparse_len * 4,
        "gen": rows * cfg.n_generated * 4,
        "lengths": rows * cfg.n_sparse * 4,
        "labels": rows * 4,
    }


# ---------------------------------------------------------------------------
# Lowering


@dataclasses.dataclass
class Stage:
    """One executable unit of the lowered plan (a fused kernel or one op)."""

    name: str
    kind: str
    family: str
    placement: str  # "isp" | "host" | "local" (pure assembly)
    inputs: Tuple[str, ...]
    outputs: Tuple[str, ...]
    fn: Callable[..., tuple]
    node_names: Tuple[str, ...]


def _spec_digest(spec: TransformSpec) -> str:
    """Content digest of everything the Transform's output depends on."""
    h = hashlib.sha256()
    h.update(
        json.dumps(dataclasses.asdict(spec.cfg), sort_keys=True, default=str).encode()
    )
    h.update(json.dumps([int(i) for i in spec.generated_source]).encode())
    for arr in (
        spec.bucket_boundaries,
        spec.sparse_seeds,
        spec.sparse_max,
        spec.gen_seeds,
        spec.gen_max,
    ):
        a = np.ascontiguousarray(np.asarray(arr))
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


@dataclasses.dataclass
class LoweredPlan:
    spec: TransformSpec
    placements: Dict[str, str]
    stages: List[Stage]
    graph: OpGraph
    device: torch.device
    gen_index: torch.Tensor  # spec.generated_source on `device`

    def structural_hash(self) -> str:
        """Stable content hash of the lowered graph (survives re-lowering).

        Covers the spec's transform parameters, the per-family placements,
        and the lowered stage structure (names, kinds, wiring) — but NOT the
        bound callables or the device, so it equals the JAX package's hash
        for the same spec and placement."""
        h = hashlib.sha256()
        h.update(_spec_digest(self.spec).encode())
        h.update(json.dumps(sorted(self.placements.items())).encode())
        for st in self.stages:
            h.update(
                json.dumps(
                    [st.name, st.kind, st.family, st.placement,
                     list(st.inputs), list(st.outputs), list(st.node_names)]
                ).encode()
            )
        return h.hexdigest()[:16]

    def execute_env(self, env: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        env = dict(env)
        for st in self.stages:
            vals = st.fn(*(env[k] for k in st.inputs))
            env.update(zip(st.outputs, vals))
        return env["minibatch"]

    def execute(self, pages: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return self.execute_env(prepare_env(pages, self.gen_index))

    def stage(self, name: str) -> Stage:
        for st in self.stages:
            if st.name == name:
                return st
        raise KeyError(name)

    def host_families(self) -> Tuple[str, ...]:
        return tuple(f for f in FAMILIES if self.placements.get(f) == HOST)

    def megabatch_safe(self) -> bool:
        """True iff every lowered stage is row-local (``kernels.
        ROW_LOCAL_KINDS``), i.e. stacking K partitions along the row axis
        and running one launch is bitwise identical to K solo launches."""
        return all(st.kind in ROW_LOCAL_KINDS for st in self.stages)


def _device_boundaries(spec: TransformSpec, device: torch.device) -> torch.Tensor:
    """The spec's bucket boundaries, checked, +inf padded and on `device`."""
    b = np.asarray(spec.bucket_boundaries, np.float32)
    if np.isnan(b).any() or (np.diff(b, axis=-1) < 0).any():
        raise ValueError("bucket boundaries must be sorted and NaN-free")
    return K.pad_boundaries(b, device)


def _hash_bank(spec: TransformSpec, table: str, device: torch.device):
    """The (seeds, table sizes) bank of SigridHash `table` on `device`."""
    seeds, maxv = (
        (spec.sparse_seeds, spec.sparse_max)
        if table == "sparse"
        else (spec.gen_seeds, spec.gen_max)
    )
    return K.u32_tensor(seeds, device), K.u32_tensor(maxv, device)


def _op_fn(node: OpNode, spec: TransformSpec, device: torch.device) -> Callable[..., tuple]:
    """Standalone pass for one operator, its spec params already on
    `device`.  Decodes, Bucketize, SigridHash and LogNorm run their
    ``OP_KERNELS`` entry; the lengths decode runs the bitpack decode (B4) at
    the lengths' width; labels and ``form_batch`` are plain glue."""
    if isinstance(node, Decode):
        if node.encoding == "bytesplit":
            kernel = OP_KERNELS[node.kind]
            return lambda w: (kernel(w),)
        if node.encoding in ("bitpack", "lengths"):
            decode, width = OP_KERNELS[node.kind], node.width
            if node.encoding == "bitpack":
                return lambda w: (decode(w, width=width),)
            # (S, G, lw) words -> (rows, S) lengths
            return lambda w: (decode(w, width=width).t(),)
        if node.encoding == "labels":
            return lambda w: (w.view(torch.float32),)
        raise ValueError(f"unknown decode encoding {node.encoding}")
    if isinstance(node, Bucketize):
        kernel, bounds = OP_KERNELS[node.kind], _device_boundaries(spec, device)
        return lambda v: (kernel(v, bounds),)
    if isinstance(node, SigridHash):
        kernel = OP_KERNELS[node.kind]
        seeds, maxv = _hash_bank(spec, node.table, device)
        return lambda v: (kernel(v, seeds, maxv),)
    if isinstance(node, LogNorm):
        kernel = OP_KERNELS[node.kind]
        return lambda v: (kernel(v),)
    if isinstance(node, FormBatch):
        cfg = spec.cfg

        def form_batch(dense_norm, sparse_hashed, lengths_i32, labels_f32,
                       gen_hashed):
            rows = labels_f32.shape[0]
            with span("opgraph.form_batch"):  # the transposes' copies
                return ({
                    "dense": dense_norm.t().contiguous(),
                    "multi_hot_ids": sparse_hashed.reshape(
                        cfg.n_sparse, rows, cfg.max_sparse_len
                    ).permute(1, 0, 2).contiguous(),
                    "lengths": lengths_i32.contiguous(),
                    "one_hot_ids": gen_hashed.t().contiguous(),
                    "labels": labels_f32.contiguous(),
                },)

        return form_batch
    raise TypeError(f"unknown node type {type(node).__name__}")


def _fused_fn(kinds: Tuple[str, ...], family: str, spec: TransformSpec,
              device: torch.device) -> Callable[..., tuple]:
    """Bind one fused kernel to the spec params its chain needs, moved to
    `device` once here so no launch copies them again."""
    kernel = FUSED_KERNELS[kinds]
    if family == "dense":
        return lambda w: (kernel(w),)
    if family == "sparse":
        seeds, maxv = _hash_bank(spec, "sparse", device)
        width = spec.cfg.id_width
        return lambda w: (kernel(w, seeds, maxv, width=width),)
    if family == "gen":
        bounds = _device_boundaries(spec, device)
        seeds, maxv = _hash_bank(spec, "gen", device)
        return lambda w: (kernel(w, bounds, seeds, maxv),)
    raise ValueError(f"no fused binding for family {family}")


def lower(
    graph: OpGraph,
    spec: TransformSpec,
    placements: Dict[str, str],
    *,
    device: torch.device | str | None = None,
) -> LoweredPlan:
    """Graph + per-family placement -> ordered stage list on `device`
    (CUDA unless the caller names another).

    ISP-placed chains whose kind tuple is registered in FUSED_KERNELS become
    one fused-kernel stage; everything else (host-placed chains, and the
    lengths and labels families anywhere) lowers to one stage per op."""
    device = resolve_device(device)
    stages: List[Stage] = []
    for family in graph.families:
        chain = graph.family_chain(family)
        place = placements.get(family, ISP)
        kinds = tuple(n.kind for n in chain)
        if place == ISP and kinds in FUSED_KERNELS:
            stages.append(
                Stage(
                    name=f"fused_{family}",
                    kind="fused:" + "+".join(kinds),
                    family=family,
                    placement=ISP,
                    inputs=chain[0].inputs,
                    outputs=(chain[-1].output,),
                    fn=_fused_fn(kinds, family, spec, device),
                    node_names=tuple(n.name for n in chain),
                )
            )
        else:
            for n in chain:
                stages.append(
                    Stage(
                        name=n.name,
                        kind=n.kind,
                        family=family,
                        placement=place,
                        inputs=n.inputs,
                        outputs=(n.output,),
                        fn=_op_fn(n, spec, device),
                        node_names=(n.name,),
                    )
                )
    form = graph.node("form_batch")
    stages.append(
        Stage(
            name=form.name,
            kind=form.kind,
            family=form.family,
            placement="local",
            inputs=form.inputs,
            outputs=(form.output,),
            fn=_op_fn(form, spec, device),
            node_names=(form.name,),
        )
    )
    gen_index = torch.as_tensor(
        np.asarray(spec.generated_source, np.int64)
    ).to(device)
    return LoweredPlan(spec=spec, placements=dict(placements), stages=stages,
                       graph=graph, device=device, gen_index=gen_index)


def lower_transform(spec: TransformSpec, mode="fused", *,
                    device: torch.device | str | None = None) -> LoweredPlan:
    """Convenience: build + lower the standard Transform in one call."""
    return lower(build_transform_graph(spec), spec, resolve_placements(mode, spec),
                 device=device)


# ---------------------------------------------------------------------------
# Stage timing (latency breakdown + per-placement-group provisioning)


def time_stages(
    plan: LoweredPlan,
    pages: Dict[str, torch.Tensor],
    *,
    iters: int = 3,
    warmup: int = 1,
) -> Dict[str, float]:
    """Best-of-`iters` wall time per lowered stage, threading real values.

    On CUDA the device is synchronised before and after every timed call,
    so each time covers the stage's kernels and not only their enqueue."""
    env = prepare_env(pages, plan.gen_index)
    on_cuda = plan.device.type == "cuda"

    def sync() -> None:
        if on_cuda:
            torch.cuda.synchronize(plan.device)

    times: Dict[str, float] = {}
    for st in plan.stages:
        args = [env[k] for k in st.inputs]
        out = None
        for _ in range(max(warmup, 1)):
            out = st.fn(*args)
        best = float("inf")
        for _ in range(max(iters, 1)):
            sync()
            t0 = time.perf_counter()
            st.fn(*args)
            sync()
            best = min(best, time.perf_counter() - t0)
        times[st.name] = best
        env.update(zip(st.outputs, out))
    return times


def group_times_by_placement(plan: LoweredPlan, times: Dict[str, float]) -> Dict[str, float]:
    """Aggregate per-stage seconds into placement groups (isp/host/local)."""
    groups: Dict[str, float] = {}
    for st in plan.stages:
        groups[st.placement] = groups.get(st.placement, 0.0) + times[st.name]
    return groups
