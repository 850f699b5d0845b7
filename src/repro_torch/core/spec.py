"""TransformSpec: the declarative description of one RecSys ETL Transform.

Mirrors what the paper's preprocess manager receives from the train manager
at job launch (step 2 of Fig. 9): which dense features are Log-normalized,
which are Bucketized into new sparse features (with which boundaries), and
the (seed, table-size) pair for every SigridHash.  The Transform has no
learned weights: these arrays are its parameters, and they stay numpy on the
host; the lowering copies them to the device once.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np

from repro_torch.data.synth import RMDataConfig, SyntheticRecSysSource

# the spec's parameter arrays and their dtypes, as the JAX package keeps them
SPEC_ARRAYS = {
    "bucket_boundaries": np.float32,
    "sparse_seeds": np.uint32,
    "sparse_max": np.uint32,
    "gen_seeds": np.uint32,
    "gen_max": np.uint32,
}


@dataclasses.dataclass
class TransformSpec:
    cfg: RMDataConfig
    # feature generation (Bucketize): generated feature g reads dense column
    # generated_source[g] and digitizes against bucket_boundaries[g].
    bucket_boundaries: np.ndarray  # (n_generated, bucket_size) f32 sorted
    generated_source: tuple[int, ...]  # static dense-column index per gen feat
    # feature normalization (SigridHash): per-table seed + embedding rows.
    sparse_seeds: np.ndarray  # (n_sparse,) uint32
    sparse_max: np.ndarray  # (n_sparse,) uint32
    gen_seeds: np.ndarray  # (n_generated,) uint32
    gen_max: np.ndarray  # (n_generated,) uint32

    @staticmethod
    def from_source(src: SyntheticRecSysSource) -> "TransformSpec":
        cfg = src.cfg
        return TransformSpec(
            cfg=cfg,
            bucket_boundaries=src.bucket_boundaries,
            generated_source=tuple(int(i) for i in src.generated_source),
            sparse_seeds=(np.arange(cfg.n_sparse, dtype=np.uint32) * 2654435761 + 1),
            sparse_max=np.full(cfg.n_sparse, cfg.embedding_rows, np.uint32),
            gen_seeds=(np.arange(cfg.n_generated, dtype=np.uint32) * 40503 + 7),
            gen_max=np.full(cfg.n_generated, cfg.embedding_rows, np.uint32),
        )

    @property
    def n_tables(self) -> int:
        return self.cfg.n_tables

    def table_sizes(self) -> np.ndarray:
        """Embedding rows per table (multi-hot tables first, then generated)."""
        return np.concatenate([self.sparse_max, self.gen_max]).astype(np.int64)

    def graph(self):
        """This Transform as the declarative operator graph (``core.opgraph``)."""
        from repro_torch.core.opgraph import build_transform_graph

        return build_transform_graph(self)


def spec_from_arrays(
    cfg_fields: Mapping[str, Any], arrays: Mapping[str, Any]
) -> TransformSpec:
    """Carry a spec across from the JAX package.

    ``cfg_fields`` is ``dataclasses.asdict(spec.cfg)`` of the JAX spec and
    ``arrays`` holds its numpy parameter arrays (``bucket_boundaries``,
    ``generated_source``, ``sparse_seeds``, ``sparse_max``, ``gen_seeds``,
    ``gen_max``).  Both are plain data, so the port never imports the JAX
    package to build the same Transform.
    """
    cfg = RMDataConfig(**dict(cfg_fields))
    params = {
        name: np.ascontiguousarray(np.asarray(arrays[name]).astype(dtype, copy=False))
        for name, dtype in SPEC_ARRAYS.items()
    }
    spec = TransformSpec(
        cfg=cfg,
        generated_source=tuple(int(i) for i in np.asarray(arrays["generated_source"])),
        **params,
    )
    want = {
        "bucket_boundaries": (cfg.n_generated, cfg.bucket_size),
        "sparse_seeds": (cfg.n_sparse,),
        "sparse_max": (cfg.n_sparse,),
        "gen_seeds": (cfg.n_generated,),
        "gen_max": (cfg.n_generated,),
    }
    for name, shape in want.items():
        got = getattr(spec, name).shape
        if got != shape:
            raise ValueError(f"{name} has shape {got}, the config needs {shape}")
    if len(spec.generated_source) != cfg.n_generated:
        raise ValueError(
            f"generated_source has {len(spec.generated_source)} entries, "
            f"the config needs {cfg.n_generated}"
        )
    return spec
