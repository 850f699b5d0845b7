"""Synthetic raw-feature sources for RM1-RM5 (Table I of the paper).

The port's own copy of ``repro.data.synth``: the same ``(cfg, rows, seed,
pid)`` gives bitwise the same partition, because every draw goes through
``numpy.random.default_rng`` in the same order.

RM1 mirrors the public Criteo dataset (13 dense / 26 sparse features, sparse
length fixed at 1).  RM2-RM5 are the paper's production-scale synthetics
(504 dense / 42 sparse, average sparse length 20) with growing numbers of
generated features and bucket sizes.  Generation is deterministic in
(seed, partition_id) so any worker can regenerate any partition.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Dict

import numpy as np

from repro_torch.data.columnar import (
    ColumnSchema,
    Partition,
    PartitionSchema,
    encode_partition,
    refs_column,
)


@dataclasses.dataclass(frozen=True)
class RMDataConfig:
    name: str
    n_dense: int
    n_sparse: int
    avg_sparse_len: int
    max_sparse_len: int
    n_generated: int  # dense features bucketized into new sparse features
    bucket_size: int  # number of bucket boundaries (m in Alg. 1)
    id_space: int  # raw sparse-id space (SigridHash squeezes into table)
    embedding_rows: int  # avg embeddings per table (d in Alg. 2)
    rows_per_partition: int = 8192
    dense_encoding: str = "bytesplit"
    sparse_encoding: str = "bitpack"
    # sample-level dedup (RecD): every `dup_factor` consecutive rows form one
    # session sharing ONE sparse-feature block; `dup_pool` > 0 draws session
    # blocks from a dataset-level pool of that many distinct blocks.
    dup_factor: int = 1
    dup_pool: int = 0

    @property
    def n_tables(self) -> int:
        return self.n_sparse + self.n_generated

    @property
    def id_width(self) -> int:
        return max(int(self.id_space - 1).bit_length(), 1)

    @property
    def len_width(self) -> int:
        return max(int(self.max_sparse_len).bit_length(), 1)


# Table I of the paper. id_space is a large raw space (ids are hashed down to
# embedding_rows by SigridHash); embedding_rows = "Avg. # Embeddings".
RM_CONFIGS: Dict[str, RMDataConfig] = {
    "rm1": RMDataConfig("rm1", 13, 26, 1, 1, 13, 1024, 1 << 24, 500_000),
    "rm2": RMDataConfig("rm2", 504, 42, 20, 32, 21, 1024, 1 << 24, 500_000),
    "rm3": RMDataConfig("rm3", 504, 42, 20, 32, 42, 1024, 1 << 24, 500_000),
    "rm4": RMDataConfig("rm4", 504, 42, 20, 32, 42, 2048, 1 << 24, 500_000),
    "rm5": RMDataConfig("rm5", 504, 42, 20, 32, 42, 4096, 1 << 24, 500_000),
}


@dataclasses.dataclass
class RawBatch:
    """Decoded raw features for one partition (pre-Transform)."""

    dense: np.ndarray  # (rows, n_dense) f32
    sparse_values: np.ndarray  # (rows, n_sparse, max_len) i32
    sparse_lengths: np.ndarray  # (rows, n_sparse) i32
    labels: np.ndarray  # (rows,) f32 in {0,1}
    # dedup datasets: row r's sparse block is unique block sparse_refs[r]
    sparse_refs: np.ndarray | None = None


def _schema_for(cfg: RMDataConfig, rows: int) -> PartitionSchema:
    cols = []
    for i in range(cfg.n_dense):
        cols.append(ColumnSchema(f"d{i}", "dense", cfg.dense_encoding))
    for i in range(cfg.n_sparse):
        cols.append(
            ColumnSchema(
                f"s{i}",
                "sparse",
                cfg.sparse_encoding,
                max_len=cfg.max_sparse_len,
                id_width=cfg.id_width,
                len_width=cfg.len_width,
                dict_size=cfg.id_space if cfg.sparse_encoding == "dict" else 0,
            )
        )
    # label column rides along as a dense column
    cols.append(ColumnSchema("label", "dense", "plain"))
    if cfg.dup_factor > 1:
        cols.append(refs_column())
    return PartitionSchema(rows=rows, columns=tuple(cols), dup_factor=cfg.dup_factor)


class SyntheticRecSysSource:
    """Deterministic partition generator + encoder for one RM config."""

    def __init__(self, cfg: RMDataConfig, rows: int | None = None, seed: int = 0):
        self.cfg = cfg
        self.rows = rows or cfg.rows_per_partition
        self.seed = seed
        if cfg.dup_factor > 1 and (
            self.rows % cfg.dup_factor or (self.rows // cfg.dup_factor) % 32
        ):
            raise ValueError(
                f"rows={self.rows} needs rows/dup_factor divisible by 32 "
                f"(dup_factor={cfg.dup_factor})"
            )
        self.schema = _schema_for(cfg, self.rows)
        self._pool_cache: Dict[int, tuple] = {}  # pool block id -> (ids, lens)
        # Dataset-level bucket boundaries (one sorted array per generated
        # feature) drawn from the dense-feature distribution's range.
        rng = np.random.default_rng(seed ^ 0x5EED)
        self.bucket_boundaries = np.sort(
            rng.lognormal(mean=1.0, sigma=2.0, size=(cfg.n_generated, cfg.bucket_size))
            .astype(np.float32),
            axis=-1,
        )
        # which dense column feeds each generated feature
        self.generated_source = (
            np.arange(cfg.n_generated, dtype=np.int32) % max(cfg.n_dense, 1)
        )

    def fingerprint(self) -> str:
        """Content identity of the dataset this source generates.

        Generation is deterministic in (cfg, rows, seed), so that triple IS
        the content: equal parameters give bitwise-equal partitions and the
        same string in both packages."""
        payload = json.dumps(
            {"cfg": dataclasses.asdict(self.cfg), "rows": self.rows,
             "seed": self.seed},
            sort_keys=True,
        )
        return hashlib.sha256(payload.encode()).hexdigest()[:16]

    # -- raw (decoded) view ------------------------------------------------
    def _sparse_block_batch(self, rng, n: int):
        """Draw n sparse blocks: ((n, S, L) ids, (n, S) lengths)."""
        cfg = self.cfg
        if cfg.max_sparse_len == 1:
            lengths = np.ones((n, cfg.n_sparse), dtype=np.int32)
        else:
            lengths = np.clip(
                rng.poisson(cfg.avg_sparse_len, size=(n, cfg.n_sparse)),
                1,
                cfg.max_sparse_len,
            ).astype(np.int32)
        # Zipf-flavored ids: square a uniform to skew toward small ids, then
        # scatter across the space with a multiplicative hash for realism.
        u = rng.random(size=(n, cfg.n_sparse, cfg.max_sparse_len))
        ids = (u * u * (cfg.id_space - 1)).astype(np.int64)
        ids = (ids * 2654435761) % cfg.id_space
        mask = np.arange(cfg.max_sparse_len)[None, None, :] < lengths[..., None]
        ids = np.where(mask, ids, 0).astype(np.int32)
        return ids, lengths

    def _pool_block(self, pool_id: int):
        """One dataset-level session block, deterministic in (seed, pool_id)."""
        blk = self._pool_cache.get(pool_id)
        if blk is None:
            rng = np.random.default_rng((self.seed << 20) ^ 0xB10C0000 ^ pool_id)
            ids, lens = self._sparse_block_batch(rng, 1)
            blk = (ids[0], lens[0])
            self._pool_cache[pool_id] = blk
        return blk

    def block_pool_ids(self, partition_id: int) -> np.ndarray | None:
        """Pool index of each unique block of one partition (dup_pool > 0)."""
        cfg = self.cfg
        if cfg.dup_factor <= 1 or cfg.dup_pool <= 0:
            return None
        n_unique = self.rows // cfg.dup_factor
        rng = np.random.default_rng((self.seed << 20) ^ 0x5E55 ^ partition_id)
        return rng.integers(0, cfg.dup_pool, size=n_unique, dtype=np.int64)

    def block_refs(self, partition_id: int) -> np.ndarray | None:
        """The (rows,) refs vector of one partition (contiguous sessions)."""
        d = self.cfg.dup_factor
        if d <= 1:
            return None
        return np.arange(self.rows, dtype=np.int64) // d

    def raw(self, partition_id: int) -> RawBatch:
        cfg, rows = self.cfg, self.rows
        rng = np.random.default_rng((self.seed << 20) ^ partition_id)
        dense = rng.lognormal(mean=1.0, sigma=2.0, size=(rows, cfg.n_dense)).astype(
            np.float32
        )
        if cfg.dup_factor <= 1:
            ids, lengths = self._sparse_block_batch(rng, rows)
            labels = (rng.random(size=(rows,)) < 0.25).astype(np.float32)
            return RawBatch(dense, ids, lengths, labels)
        # dedup dataset: one sparse block per session of dup_factor rows
        n_unique = rows // cfg.dup_factor
        pool_ids = self.block_pool_ids(partition_id)
        if pool_ids is None:
            uids, ulens = self._sparse_block_batch(rng, n_unique)
        else:
            blocks = [self._pool_block(int(p)) for p in pool_ids]
            uids = np.stack([b[0] for b in blocks])
            ulens = np.stack([b[1] for b in blocks])
        labels = (rng.random(size=(rows,)) < 0.25).astype(np.float32)
        refs = self.block_refs(partition_id)
        return RawBatch(dense, uids[refs], ulens[refs], labels, refs)

    # -- encoded partition ---------------------------------------------------
    def partition(self, partition_id: int) -> Partition:
        raw = self.raw(partition_id)
        cfg = self.cfg
        dense = {f"d{i}": raw.dense[:, i] for i in range(cfg.n_dense)}
        dense["label"] = raw.labels
        svals = {f"s{i}": raw.sparse_values[:, i] for i in range(cfg.n_sparse)}
        slens = {f"s{i}": raw.sparse_lengths[:, i] for i in range(cfg.n_sparse)}
        return encode_partition(
            partition_id, self.schema, dense, svals, slens,
            sparse_refs=raw.sparse_refs,
        )


def make_rm_source(
    name: str, rows: int | None = None, seed: int = 0
) -> SyntheticRecSysSource:
    cfg = RM_CONFIGS[name.lower()]
    return SyntheticRecSysSource(cfg, rows=rows, seed=seed)
