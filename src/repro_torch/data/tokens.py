"""Synthetic token streams for the LM-family architectures: the port of
``repro.data.tokens`` (numpy only, the same numbers).

PreSto's feature-level ops are tabular-only, but its *placement* idea
(preprocess each data shard where it lives, zero redistribution) applies to
any ingestion pipeline.  For LM archs the per-shard preprocessing is:
decode -> pack documents to fixed seq_len -> shift labels -> mask pads.
Generation is deterministic in (seed, shard, step), with the reference's
seed mix, so any host regenerates any shard bitwise as the reference does
(elastic restart / straggler re-issue safe).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenSynthesizer:
    vocab_size: int
    seq_len: int
    seed: int = 0

    def shard_batch(self, shard: int, step: int, per_shard_batch: int) -> dict:
        """One local shard's batch: tokens/labels/segment_ids/mask of
        (B_local, seq), numpy."""
        rng = np.random.default_rng(
            (self.seed << 40) ^ (shard << 20) ^ (step & 0xFFFFF)
        )
        # zipf-ish unigram stream: realistic skew without a real corpus
        u = rng.random(size=(per_shard_batch, self.seq_len + 1))
        toks = ((u ** 3.0) * (self.vocab_size - 2)).astype(np.int32) + 1
        # random document boundaries -> packing mask
        doclen = rng.integers(64, self.seq_len + 1)
        pos = np.arange(self.seq_len)
        segment = (pos // max(doclen, 1)).astype(np.int32)
        return {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:],
            "segment_ids": np.broadcast_to(segment, (per_shard_batch, self.seq_len)).copy(),
            "mask": np.ones((per_shard_batch, self.seq_len), dtype=np.bool_),
        }


def lm_input_batch(
    vocab_size: int, seq_len: int, global_batch: int, seed: int = 0, step: int = 0
) -> dict:
    """Full global batch on host (small configs / tests only)."""
    synth = TokenSynthesizer(vocab_size, seq_len, seed)
    return synth.shard_batch(shard=0, step=step, per_shard_batch=global_batch)
