"""Config lookup by name: the LM architectures (``--arch <id>``) and the
RecSys models.

The port of ``repro.configs.registry``.  Every architecture resolves, and
its configs mean what the reference's do; which of them the port can serve
today is ``models.transformer``'s business (the dense family; the MoE,
hybrid, SSM and encoder-decoder ones raise there).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

from repro_torch.configs import recsys_rm
from repro_torch.models.config import ModelConfig
from repro_torch.models.recsys import RecSysConfig

_MODULES: Dict[str, str] = {
    "h2o-danube-1.8b": "repro_torch.configs.h2o_danube_1_8b",
    "gemma-7b": "repro_torch.configs.gemma_7b",
    "glm4-9b": "repro_torch.configs.glm4_9b",
    "gemma3-12b": "repro_torch.configs.gemma3_12b",
    "internvl2-76b": "repro_torch.configs.internvl2_76b",
    "grok-1-314b": "repro_torch.configs.grok1_314b",
    "llama4-maverick-400b-a17b": "repro_torch.configs.llama4_maverick_400b",
    "jamba-v0.1-52b": "repro_torch.configs.jamba_v0_1_52b",
    "seamless-m4t-medium": "repro_torch.configs.seamless_m4t_medium",
    "mamba2-1.3b": "repro_torch.configs.mamba2_1_3b",
}

ARCH_IDS = tuple(_MODULES)


@dataclasses.dataclass(frozen=True)
class ArchEntry:
    config: ModelConfig
    reduced: ModelConfig
    skip_shapes: frozenset


def get_arch(arch_id: str) -> ArchEntry:
    mod = importlib.import_module(_MODULES[arch_id])
    return ArchEntry(mod.CONFIG, mod.REDUCED, mod.SKIP_SHAPES)


def list_arch_ids() -> tuple:
    return ARCH_IDS


def get_recsys(name: str, *, reduced: bool = False) -> RecSysConfig:
    return (recsys_rm.REDUCED if reduced else recsys_rm.CONFIGS)[name]
