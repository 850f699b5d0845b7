"""RM1-RM5 — the paper's own RecSys data configurations (Table I).

RM1 = public Criteo scale; RM2-5 = production-scale synthetics.  The port
carries the data side only: the model configurations arrive with the
training slice.  REDUCED variants (small bucket sets, tiny id spaces and
tables) run the smoke tests on the CPU.
"""

import dataclasses

from repro_torch.data.synth import RM_CONFIGS, RMDataConfig

CONFIGS = {f"rm{i}": RM_CONFIGS[f"rm{i}"] for i in range(1, 6)}


def reduced_data(cfg: RMDataConfig, rows: int = 256) -> RMDataConfig:
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        bucket_size=min(cfg.bucket_size, 64),
        id_space=1 << 16,
        embedding_rows=1024,
        rows_per_partition=rows,
    )


REDUCED = {name: reduced_data(cfg) for name, cfg in CONFIGS.items()}
