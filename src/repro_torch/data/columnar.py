"""Partitioned columnar format (Parquet-lite) for raw RecSys features.

The port's own copy of the in-memory half of ``repro.data.columnar``: the
schema, the encoded partition, its numpy encode/decode and
``inflate_partition``.  File I/O, checksums and ``block_fingerprints`` are
not carried yet.

A *partition* is a self-contained group of rows (one training mini-batch in
the paper: 8,192 rows).  Partitions are mutually independent — the property
PreSto exploits: all transforms for a mini-batch touch exactly one partition,
so preprocessing can run wherever that partition lives with zero cross-shard
communication.  Each column's pages are contiguous uint32 word arrays whose
sizes are fully determined by the dataset-level schema.

Column kinds
------------
dense : float32 per row.  encodings: 'plain' | 'bytesplit'
sparse: variable-length list of int32 ids per row, stored ragged:
        lengths  bitpacked at `len_width` bits   (per-row list lengths)
        values   bitpacked at `id_width` bits or dictionary-encoded
refs  : per-sample unique-block references (dedup form only, see below)

Sample-level dedup (RecD)
-------------------------
A schema with ``dup_factor = d > 1`` stores each partition in *dedup form*:
every sparse column's lengths/values pages are encoded at
``unique_rows = rows/d`` geometry (one copy per block), and one
partition-wide ``__refs__`` page maps each of the ``rows`` logical samples to
its unique block.  Dense columns and labels stay per-sample.
``dup_factor == 1`` is bit-for-bit the classic layout (no refs page).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping

import numpy as np

from repro_torch.data import encoding as enc

# partition-wide pseudo-column holding the per-sample block references of a
# dedup-form partition (kind "refs"; exactly one per schema when dup_factor>1)
REFS_COLUMN = "__refs__"


def refs_column() -> "ColumnSchema":
    return ColumnSchema(REFS_COLUMN, "refs", "plain")


@dataclasses.dataclass(frozen=True)
class ColumnSchema:
    name: str
    kind: str  # 'dense' | 'sparse' | 'refs'
    encoding: str  # dense: 'plain'|'bytesplit'; sparse: 'bitpack'|'dict'
    # sparse-only static parameters (dataset-level, fixed across partitions):
    max_len: int = 1  # padded list length after decode
    id_width: int = 32  # bit width of raw ids ('bitpack')
    len_width: int = 8  # bit width of per-row lengths
    dict_size: int = 0  # >0 for 'dict' encoding (fixed dictionary capacity)

    @property
    def code_width(self) -> int:
        return enc.width_for(max(self.dict_size - 1, 1))


@dataclasses.dataclass(frozen=True)
class PartitionSchema:
    """Dataset-level schema: identical for every partition of a dataset."""

    rows: int
    columns: tuple[ColumnSchema, ...]
    # sample-level dedup: every ``dup_factor`` consecutive rows of a session
    # share ONE stored sparse-feature block.  1 = classic per-sample layout.
    dup_factor: int = 1

    def __post_init__(self):
        if self.dup_factor < 1:
            raise ValueError(f"dup_factor={self.dup_factor} must be >= 1")
        if self.dup_factor > 1:
            if self.rows % self.dup_factor:
                raise ValueError(
                    f"rows={self.rows} not divisible by dup_factor={self.dup_factor}"
                )
            if not any(c.kind == "refs" for c in self.columns):
                raise ValueError(
                    "dedup schema (dup_factor > 1) needs a refs column "
                    "(columnar.refs_column())"
                )

    @property
    def unique_rows(self) -> int:
        """Stored sparse-block count per partition (== rows when dup 1)."""
        return self.rows // self.dup_factor

    def logical_schema(self) -> "PartitionSchema":
        """The undeduped (dup_factor 1, no refs column) view of this schema —
        the layout the same logical rows would occupy without dedup."""
        if self.dup_factor == 1:
            return self
        return PartitionSchema(
            rows=self.rows,
            columns=tuple(c for c in self.columns if c.kind != "refs"),
            dup_factor=1,
        )


@dataclasses.dataclass
class EncodedColumn:
    schema: ColumnSchema
    pages: Dict[str, np.ndarray]  # page name -> uint32 words


@dataclasses.dataclass
class Partition:
    """One encoded partition: the unit of in-storage preprocessing."""

    partition_id: int
    schema: PartitionSchema
    columns: Dict[str, EncodedColumn]

    def nbytes(self) -> int:
        """Actual stored bytes — UNIQUE block bytes for a dedup partition."""
        return sum(
            int(p.nbytes) for c in self.columns.values() for p in c.pages.values()
        )

    def page_arrays(self) -> Dict[str, np.ndarray]:
        """Flat dict 'col/page' -> words, the kernel-side input layout."""
        out = {}
        for cname, col in self.columns.items():
            for pname, words in col.pages.items():
                out[f"{cname}/{pname}"] = words
        return out


def encode_partition(
    partition_id: int,
    schema: PartitionSchema,
    dense: Mapping[str, np.ndarray],
    sparse_values: Mapping[str, np.ndarray],
    sparse_lengths: Mapping[str, np.ndarray],
    sparse_refs: np.ndarray | None = None,
) -> Partition:
    """Encode raw host arrays into a Partition.

    dense[name]         : (rows,) float
    sparse_values[name] : (rows, max_len) int — entries beyond length are 0
    sparse_lengths[name]: (rows,) int, each <= max_len
    sparse_refs         : (rows,) int in [0, unique_rows) — dedup schemas
                          only; row r's sparse block is unique block refs[r].
                          Defaults to contiguous sessions (r // dup_factor).
                          Every block must be referenced, and all rows of a
                          block must carry IDENTICAL sparse values/lengths.
    """
    d = schema.dup_factor
    first_rows = None  # logical row defining each unique block, dedup only
    if d > 1:
        if sparse_refs is None:
            sparse_refs = np.arange(schema.rows, dtype=np.int64) // d
        refs = np.asarray(sparse_refs, dtype=np.int64)
        u = schema.unique_rows
        if refs.shape != (schema.rows,):
            raise ValueError(f"sparse_refs shape {refs.shape} != ({schema.rows},)")
        if refs.min(initial=0) < 0 or refs.max(initial=0) >= u:
            raise ValueError(f"sparse_refs outside [0, {u})")
        # first occurrence of each block defines its stored content
        first_rows = np.full(u, -1, dtype=np.int64)
        rev = np.arange(schema.rows - 1, -1, -1)
        first_rows[refs[rev]] = rev  # walk reversed: lowest row index wins
        if (first_rows < 0).any():
            raise ValueError("unreferenced unique block(s)")
    elif sparse_refs is not None and not np.array_equal(
        np.asarray(sparse_refs), np.arange(schema.rows)
    ):
        raise ValueError("sparse_refs is meaningless on a dup_factor-1 schema")
    cols: Dict[str, EncodedColumn] = {}
    for cs in schema.columns:
        if cs.kind == "refs":
            cols[cs.name] = EncodedColumn(cs, {"refs": refs.astype(np.uint32)})
        elif cs.kind == "dense":
            v = np.asarray(dense[cs.name], dtype=np.float32)
            if v.shape != (schema.rows,):
                raise ValueError(f"{cs.name}: shape {v.shape} != ({schema.rows},)")
            if cs.encoding == "bytesplit":
                words, _ = enc.bytesplit_encode(v)
            else:
                words = enc.plain_f32_encode(v)
            cols[cs.name] = EncodedColumn(cs, {"data": words})
        else:
            vals = np.asarray(sparse_values[cs.name], dtype=np.int64)
            lens = np.asarray(sparse_lengths[cs.name], dtype=np.int64)
            if vals.shape != (schema.rows, cs.max_len):
                raise ValueError(f"{cs.name}: values shape {vals.shape}")
            if lens.max(initial=0) > cs.max_len:
                raise ValueError(f"{cs.name}: a length exceeds max_len={cs.max_len}")
            if first_rows is not None:
                # dedup: store one copy per unique block, losslessly —
                # every row must equal its block's defining row
                if not (
                    np.array_equal(vals, vals[first_rows][refs])
                    and np.array_equal(lens, lens[first_rows][refs])
                ):
                    raise ValueError(
                        f"{cs.name}: rows referencing one block differ in content"
                    )
                vals, lens = vals[first_rows], lens[first_rows]
            flat = vals.reshape(-1)
            pages = {"lengths": enc.bitpack(lens, cs.len_width)}
            if cs.encoding == "dict":
                # fixed-capacity dictionary: ids are already < dict_size by
                # construction (dataset-level id space)
                dictionary = np.arange(cs.dict_size, dtype=np.int32)
                pages["dict"] = dictionary.view(np.uint32)
                pages["values"] = enc.bitpack(flat, cs.code_width)
            else:
                pages["values"] = enc.bitpack(flat, cs.id_width)
            cols[cs.name] = EncodedColumn(cs, pages)
    return Partition(partition_id, schema, cols)


def decode_partition_numpy(part: Partition) -> dict:
    """Numpy decode oracle: Partition -> raw feature arrays.

    Returns {'dense': {name: (rows,) f32},
             'sparse_values': {name: (rows, max_len) i32},
             'sparse_lengths': {name: (rows,) i32}}
    (+ 'sparse_refs': (rows,) i64 for dedup partitions, whose unique blocks
    are expanded through the refs page to the logical rows)
    """
    schema = part.schema
    out = {"dense": {}, "sparse_values": {}, "sparse_lengths": {}}
    refs = partition_refs(part)
    if schema.dup_factor > 1:
        out["sparse_refs"] = refs
    u = schema.unique_rows
    for cs in schema.columns:
        if cs.kind == "refs":
            continue
        col = part.columns[cs.name]
        if cs.kind == "dense":
            if cs.encoding == "bytesplit":
                out["dense"][cs.name] = enc.bytesplit_decode(
                    col.pages["data"], schema.rows
                )
            else:
                out["dense"][cs.name] = enc.plain_f32_decode(
                    col.pages["data"], schema.rows
                )
        else:
            total = u * cs.max_len
            lens = enc.bitunpack(col.pages["lengths"], u, cs.len_width)
            if cs.encoding == "dict":
                dictionary = col.pages["dict"].view(np.int32)
                vals = enc.dict_decode(
                    dictionary, col.pages["values"], total, cs.code_width
                )
            else:
                vals = enc.bitunpack(col.pages["values"], total, cs.id_width).astype(
                    np.int32
                )
            vals = vals.reshape(u, cs.max_len)
            lens = lens.astype(np.int32)
            if refs is not None:
                vals, lens = vals[refs], lens[refs]  # expand to logical rows
            out["sparse_values"][cs.name] = vals
            out["sparse_lengths"][cs.name] = lens
    return out


def partition_refs(part: Partition) -> np.ndarray | None:
    """The (rows,) block-reference vector of a dedup partition, else None."""
    if part.schema.dup_factor == 1:
        return None
    return part.columns[REFS_COLUMN].pages["refs"].astype(np.int64)


def inflate_partition(part: Partition) -> Partition:
    """Dedup form -> classic per-sample layout, bitwise faithful.

    Decodes the unique sparse blocks, expands them through the refs page and
    re-encodes at logical geometry under ``schema.logical_schema()`` — the
    partition an undeduped source would have produced for the same rows
    (bitpack(bitunpack(x)) is exact for in-width values).  Dense pages are
    reused as-is."""
    schema = part.schema
    if schema.dup_factor == 1:
        return part
    dec = decode_partition_numpy(part)
    logical = schema.logical_schema()
    cols: Dict[str, EncodedColumn] = {}
    for cs in logical.columns:
        if cs.kind == "dense":
            cols[cs.name] = EncodedColumn(cs, dict(part.columns[cs.name].pages))
        else:
            lens = dec["sparse_lengths"][cs.name].astype(np.int64)
            flat = dec["sparse_values"][cs.name].astype(np.int64).reshape(-1)
            pages = {"lengths": enc.bitpack(lens, cs.len_width)}
            if cs.encoding == "dict":
                pages["dict"] = np.arange(cs.dict_size, dtype=np.int32).view(np.uint32)
                pages["values"] = enc.bitpack(flat, cs.code_width)
            else:
                pages["values"] = enc.bitpack(flat, cs.id_width)
            cols[cs.name] = EncodedColumn(cs, pages)
    return Partition(part.partition_id, logical, cols)
