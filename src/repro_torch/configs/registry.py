"""Config lookup by name: the RecSys models (the LM architectures of the
reference's registry wait for the LM side of the port)."""

from __future__ import annotations

from repro_torch.configs import recsys_rm
from repro_torch.models.recsys import RecSysConfig


def get_recsys(name: str, *, reduced: bool = False) -> RecSysConfig:
    return (recsys_rm.REDUCED if reduced else recsys_rm.CONFIGS)[name]
