"""RM1-RM5 — the paper's own RecSys models (Table I).

RM1 = public Criteo scale; RM2-5 = production-scale synthetics.  ``CONFIGS``
are the full models (``RecSysConfig``, with their data configs under
``.data``); ``REDUCED`` variants (small bucket sets, tiny id spaces and
tables) run the tests on the CPU.
"""

import dataclasses

from repro_torch.data.synth import RM_CONFIGS, RMDataConfig
from repro_torch.models.recsys import RecSysConfig

CONFIGS = {
    f"rm{i}": RecSysConfig(name=f"rm{i}", data=RM_CONFIGS[f"rm{i}"])
    for i in range(1, 6)
}


def reduced_data(cfg: RMDataConfig, rows: int = 256) -> RMDataConfig:
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        bucket_size=min(cfg.bucket_size, 64),
        id_space=1 << 16,
        embedding_rows=1024,
        rows_per_partition=rows,
    )


REDUCED = {
    f"rm{i}": RecSysConfig(name=f"rm{i}-smoke", data=reduced_data(RM_CONFIGS[f"rm{i}"]))
    for i in range(1, 6)
}
