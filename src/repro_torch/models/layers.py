"""Schema-driven parameters: the schema half of ``repro.models.layers``.

A model declares its parameters once as a nested dict of ``ParamDef``;
``init_from_schema`` turns the schema into tensors.  The reference draws
from ``jax.random`` and this port from ``torch.Generator``: the two give
different numbers from the same seed, so parity tests carry the reference's
initialized weights across as numpy (``recsys.params_from_numpy``) instead
of initializing twice.  ``pspecs_from_schema`` maps the schema's logical
axes to mesh axes through ``distributed.sharding.ShardingRules``.
"""

from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Any, Dict, Optional

import torch


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple
    axes: tuple  # logical axis names (len == ndim); the meshed port reads them
    init: str = "normal"  # normal | zeros | ones
    scale: Optional[float] = None  # None -> 1/sqrt(fan_in)

    def fan_in(self) -> int:
        # second-minor dim: (d_in, d_out) and stacked layouts alike
        return self.shape[-2] if len(self.shape) > 1 else self.shape[-1]


Schema = Dict[str, Any]  # nested dict of ParamDef


def _path_seed(path: str) -> int:
    return zlib.crc32(path.encode())


def init_from_schema(
    generator: torch.Generator, schema: Schema, dtype: torch.dtype, device: torch.device
) -> Dict[str, Any]:
    """Nested dict of tensors on `device`, one per ``ParamDef``.  Each
    normal leaf draws from its own generator on `device`, seeded by
    `generator`'s seed and the leaf's path (the counterpart of the
    reference's ``fold_in``), so a leaf's values do not depend on the order
    of the schema.  Leaves are filled in place: a full-size table takes no
    second buffer."""
    base = generator.initial_seed()

    def walk(node, path):
        if isinstance(node, ParamDef):
            if node.init == "zeros":
                return torch.zeros(node.shape, dtype=dtype, device=device)
            if node.init == "ones":
                return torch.ones(node.shape, dtype=dtype, device=device)
            scale = node.scale if node.scale is not None else 1.0 / math.sqrt(
                max(node.fan_in(), 1)
            )
            leaf = torch.Generator(device=device)
            leaf.manual_seed((base * 0x9E3779B1 + _path_seed(path)) % (1 << 63))
            t = torch.empty(node.shape, dtype=torch.float32, device=device)
            return t.normal_(generator=leaf).mul_(scale).to(dtype)
        return {k: walk(v, f"{path}/{k}") for k, v in node.items()}

    return walk(schema, "")


def pspecs_from_schema(schema: Schema, rules) -> Dict[str, Any]:
    """Nested dict of specs (``rules.pspec`` of each leaf's logical axes)."""

    def walk(node):
        if isinstance(node, ParamDef):
            return rules.pspec(*node.axes)
        return {k: walk(v) for k, v in node.items()}

    return walk(schema)
