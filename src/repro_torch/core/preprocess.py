"""The ETL Transform: encoded pages -> train-ready mini-batch.

The port of ``repro.core.preprocess``.  The Transform is declared once as an
operator graph (``repro_torch.core.opgraph``) and lowered per placement;
everything here is a thin wrapper over that lowering.  Page staging stays
numpy on the host (it is the same layout the JAX package builds); the
Transform runs on PyTorch tensors, on the device the pages were put on.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.common.util import ShapeDtype, span
from repro_torch.core.opgraph import (
    LoweredPlan,
    build_transform_graph,
    lower,
    prepare_env,
    resolve_placements,
)
from repro_torch.core.spec import TransformSpec
from repro_torch.data.columnar import Partition, partition_refs
from repro_torch.data.storage import CorruptPartitionError
from repro_torch.kernels import ops as K

MiniBatch = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Host-side page staging: Partition (numpy, flat pages) -> kernel layout


def pages_from_partition(part: Partition, spec: TransformSpec) -> Dict[str, np.ndarray]:
    """Stack per-column pages into the grouped uint32 arrays the kernels
    consume.  Dedup partitions (``schema.dup_factor > 1``) stage their
    sparse/length pages at unique-block geometry — each shared block's
    encoded words go to the device once — plus a ``sparse_refs`` vector
    mapping the ``rows`` logical samples back to blocks, exactly as the JAX
    package does; the Transform gather-expands after hashing
    (``execute_plan``).

    The refs are checked against ``[0, u)`` here, on the host, before any
    page is built: a ref outside it raises a non-retryable
    ``CorruptPartitionError``.  The JAX package's ``jnp.take`` would fill
    such a ref with INT_MIN (or wrap a negative one); PyTorch's gather on
    the card would assert on the device and end the CUDA context."""
    cfg = spec.cfg
    rows = part.schema.rows
    u = part.schema.unique_rows  # == rows for classic partitions
    refs = partition_refs(part)
    if refs is not None and refs.size and (refs.min() < 0 or refs.max() >= u):
        bad = int(((refs < 0) | (refs >= u)).sum())
        raise CorruptPartitionError(
            f"partition {part.partition_id}: {bad} dedup ref(s) outside [0, {u})",
            pid=part.partition_id, retryable=False,
        )
    dense = []
    for i in range(cfg.n_dense):
        col = part.columns[f"d{i}"]
        dense.append(K.regroup_bytesplit(col.pages["data"], rows))
    sparse, lengths = [], []
    n_vals = u * cfg.max_sparse_len
    for i in range(cfg.n_sparse):
        col = part.columns[f"s{i}"]
        sparse.append(K.regroup_bitpack(col.pages["values"], n_vals, cfg.id_width))
        lengths.append(K.regroup_bitpack(col.pages["lengths"], u, cfg.len_width))
    label_words = part.columns["label"].pages["data"][:rows]
    pages = {
        "dense_words": np.stack(dense),  # (n_dense, rows/4, 4) u32
        "sparse_words": np.stack(sparse),  # (n_sparse, u*L/32, w) u32
        "length_words": np.stack(lengths),  # (n_sparse, u/32, lw) u32
        "label_words": label_words,  # (rows,) u32
    }
    if refs is not None:
        pages["sparse_refs"] = refs.astype(np.int32)  # (rows,) block index
    return pages


def pages_shape_dtypes(spec: TransformSpec, rows: int) -> Dict[str, ShapeDtype]:
    """Shapes and dtypes of one partition's staged page tensors, as the
    engine puts them on its device: int32 views of the uint32 words.
    Sparse/length pages live at unique-block geometry when the dataset
    dedups, matching ``pages_from_partition``."""
    cfg = spec.cfg
    u = rows // cfg.dup_factor
    i32 = torch.int32
    out = {
        "dense_words": ShapeDtype((cfg.n_dense, rows // 4, 4), i32),
        "sparse_words": ShapeDtype(
            (cfg.n_sparse, u * cfg.max_sparse_len // 32, cfg.id_width), i32
        ),
        "length_words": ShapeDtype((cfg.n_sparse, u // 32, cfg.len_width), i32),
        "label_words": ShapeDtype((rows,), i32),
    }
    if cfg.dup_factor > 1:
        out["sparse_refs"] = ShapeDtype((rows,), i32)
    return out


def megabatch_pages_shape_dtypes(spec: TransformSpec, rows: int, k: int) -> Dict[str, ShapeDtype]:
    """Shapes and dtypes of a K-partition stacked megabatch's pages."""
    return {name: ShapeDtype((k, *s.shape), s.dtype)
            for name, s in pages_shape_dtypes(spec, rows).items()}


def stack_pages(pages_list) -> Dict[str, np.ndarray]:
    """Stack K partitions' staged pages into one leading-axis megabatch."""
    pages_list = list(pages_list)
    if len(pages_list) == 1:
        return {k: v[None] for k, v in pages_list[0].items()}
    return {k: np.stack([p[k] for p in pages_list]) for k in pages_list[0]}


def flatten_megabatch(stacked: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Fold the leading megabatch axis into the row-group axis.

    Every page array is grouped ``(features, row_groups, words)`` with the
    feature axis leading (labels are flat ``(rows,)``), and every operator in
    the standard Transform is row-local — so a K-partition megabatch is
    exactly a single partition with K x the rows: ``(K, F, G, w)`` becomes
    ``(F, K*G, w)`` (partition-major row order) and ``(K, R)`` becomes
    ``(K*R,)``.  Its device work (the refs' offsets; the copies of K > 1)
    runs in the span ``preprocess.flatten_megabatch``."""
    out: Dict[str, torch.Tensor] = {}
    with span("preprocess.flatten_megabatch"):
        for name, v in stacked.items():
            if name == "sparse_refs":
                # (K, rows) block refs -> (K*rows,) into the K*u flattened
                # unique blocks: partition k's blocks land at offset k*u once
                # the sparse/length pages fold their own row-group axes below
                k = v.shape[0]
                u = stacked["length_words"].shape[2] * 32
                off = torch.arange(k, dtype=v.dtype, device=v.device)[:, None] * u
                out[name] = (v + off).reshape(-1)
            elif v.dim() == 2:  # label_words: (K, rows) -> (K*rows,)
                out[name] = v.reshape(-1)
            else:  # (K, F, G, w) -> (F, K*G, w)
                k, f, g, w = v.shape
                out[name] = v.movedim(0, 1).reshape(f, k * g, w)
    return out


# ---------------------------------------------------------------------------
# Transform entry points (all lowered from the operator graph)


def execute_plan(plan: LoweredPlan, pages: Dict[str, torch.Tensor]) -> MiniBatch:
    """Run a lowered plan over staged page tensors, dedup-aware.

    Classic pages run ``plan.execute`` untouched.  Dedup pages (carrying
    ``sparse_refs``) run the sparse/length stages at unique-block geometry —
    decode and SigridHash touch each shared block once — then gather-expand
    ``sparse_hashed`` and ``lengths_i32`` through the refs on the pages'
    device just before ``form_batch``.  Every sparse-chain operator is
    per-value row-local, so transform-then-expand is bitwise identical to
    expand-then-transform: the undeduped result, for fused, unfused and
    hybrid lowerings alike.  The expand runs in the span
    ``preprocess.dedup_expand``."""
    if "sparse_refs" not in pages:
        return plan.execute(pages)
    pages = dict(pages)
    refs = pages.pop("sparse_refs")
    L = plan.spec.cfg.max_sparse_len
    env = prepare_env(pages, plan.gen_index)
    for st in plan.stages:
        if st.name == "form_batch":
            with span("preprocess.dedup_expand"):
                sh = env["sparse_hashed"]  # (n_sparse, u*L) at unique geometry
                s, ul = sh.shape
                env["sparse_hashed"] = (
                    sh.reshape(s, ul // L, L).index_select(1, refs).reshape(s, -1)
                )
                env["lengths_i32"] = env["lengths_i32"].index_select(0, refs)
        env.update(zip(st.outputs, st.fn(*(env[k] for k in st.inputs))))
    return env["minibatch"]


def preprocess_pages(
    pages: Dict[str, torch.Tensor], spec: TransformSpec, *, mode="fused"
) -> MiniBatch:
    """Full Transform for one partition's page tensors (int32 views of the
    uint32 words), on the device they lie on, lowered under `mode` (any
    mode or dict ``opgraph.resolve_placements`` takes; every one gives the
    same batch).

    Output:
      dense          (rows, n_dense) f32      — Log-normalized
      multi_hot_ids  (rows, n_sparse, L) i32  — SigridHashed raw sparse ids
      lengths        (rows, n_sparse) i32     — multi-hot lengths
      one_hot_ids    (rows, n_generated) i32  — Bucketize+SigridHash generated
      labels         (rows,) f32
    """
    placements = resolve_placements(mode, spec)
    plan = lower(
        build_transform_graph(spec), spec, placements,
        device=pages["dense_words"].device,
    )
    return execute_plan(plan, pages)


def minibatch_shape_dtypes(spec: TransformSpec, rows: int) -> Dict[str, ShapeDtype]:
    cfg = spec.cfg
    return {
        "dense": ShapeDtype((rows, cfg.n_dense), torch.float32),
        "multi_hot_ids": ShapeDtype(
            (rows, cfg.n_sparse, cfg.max_sparse_len), torch.int32
        ),
        "lengths": ShapeDtype((rows, cfg.n_sparse), torch.int32),
        "one_hot_ids": ShapeDtype((rows, cfg.n_generated), torch.int32),
        "labels": ShapeDtype((rows,), torch.float32),
    }


# ---------------------------------------------------------------------------
# Stage-split functions for the latency breakdown (Fig. 5 / Fig. 12)


def stage_functions(spec: TransformSpec, *, device: torch.device | str | None = None):
    """Plain callables per ETL stage, under the paper's stage names, for
    stage timing on `device` (CUDA unless the caller names another).

    Thin adapter over the all-host lowering: every body is a lowered graph
    stage (no transform logic lives here), regrouped into the paper's
    stages."""
    plan = lower(
        build_transform_graph(spec), spec, resolve_placements("unfused", spec),
        device=device,
    )
    fns = {st.name: st.fn for st in plan.stages}
    gen_index = plan.gen_index

    def extract_decode(pages):
        dense_raw = fns["decode_dense"](pages["dense_words"])[0]
        sparse_raw = fns["decode_sparse"](pages["sparse_words"])[0]
        return dense_raw, sparse_raw

    def gen_bucketize(dense_raw):
        return fns["bucketize_gen"](dense_raw.index_select(0, gen_index))[0]

    def norm_sigridhash(sparse_raw, bucket_ids):
        return fns["hash_sparse"](sparse_raw)[0], fns["hash_gen"](bucket_ids)[0]

    def norm_log(dense_raw):
        return fns["lognorm_dense"](dense_raw)[0]

    def form_minibatch(pages, dense_norm, hashed, gen_hashed):
        lengths = fns["decode_lengths"](pages["length_words"])[0]
        labels = fns["decode_labels"](pages["label_words"])[0]
        return fns["form_batch"](dense_norm, hashed, lengths, labels, gen_hashed)[0]

    return {
        "extract_decode": extract_decode,
        "gen_bucketize": gen_bucketize,
        "norm_sigridhash": norm_sigridhash,
        "norm_log": norm_log,
        "form_minibatch": form_minibatch,
    }
