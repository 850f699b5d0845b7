"""Roofline terms of a step on the H100, and the model-FLOP count: the port of
``repro.launch.roofline``.

    compute_s    = FLOPs a card     / 989e12 FLOP/s  (bf16 dense, H100 SXM)
    memory_s     = bytes a card     / 3.35e12 B/s    (HBM3, H100 SXM)
    collective_s = collective bytes / 450e9 B/s      (NVLink, one direction)

The rates are NVIDIA's H100 SXM data sheet.  NVLink's 900 GB/s is the
card's total over both directions; a rank's collective bytes are what it
sends (``distributed.comm``'s payload count), and a card sends at half of
the total while it receives at the other half, so ``collective_s`` divides
by 450e9.

The reference derives its terms from compiled HLO.  The port has no HLO, so
``derive`` counts what it can observe of one call of the step: its FLOPs
with ``torch.utils.flop_counter.FlopCounterMode`` (matrix products,
convolutions, attention; elementwise work counts zero, as in the HLO's dot
count), its bytes as its inputs read once plus its outputs written once
(the least any implementation moves), and its collective bytes from the
mesh's ``CommCounter``.  ``collective_bytes(hlo_text)``, the reference's
parse of HLO text, has no counterpart.

``param_counts`` and ``model_flops`` read the model schema, as the
reference's do: 6·N_active·D for training and 2·N_active·D for inference,
with N_active counting ``top_k / n_experts`` of every expert tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np

from repro_torch.common.util import bytes_of_tree

PEAK_FLOPS = 989e12  # bf16 dense FLOP/s a card (H100 SXM)
HBM_BW = 3.35e12  # B/s a card (H100 SXM, HBM3)
NVLINK_BW = 900e9  # B/s a card, both directions together (H100 SXM, NVLink 4)
LINK_BW = NVLINK_BW / 2  # B/s a card sends at


@dataclasses.dataclass
class RooflineTerms:
    flops_per_dev: float
    hbm_bytes_per_dev: float
    coll_bytes_per_dev: int
    coll_breakdown: Dict[str, int]
    model_flops_global: float
    chips: int

    @property
    def compute_s(self) -> float:
        return self.flops_per_dev / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes_per_dev / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.coll_bytes_per_dev / LINK_BW

    @property
    def dominant(self) -> str:
        vals = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(vals, key=vals.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        """Model FLOPs over the counted FLOPs of all cards: the share of
        the work the model needs (remat and redundancy are the rest)."""
        return self.model_flops_global / max(self.flops_per_dev * self.chips, 1.0)

    @property
    def roofline_fraction(self) -> float:
        """Model compute time over the step's lower bound."""
        model_s = self.model_flops_global / (self.chips * PEAK_FLOPS)
        return model_s / max(self.bound_s, 1e-30)

    def to_json(self) -> dict:
        return {
            "flops_per_dev": self.flops_per_dev,
            "hbm_bytes_per_dev": self.hbm_bytes_per_dev,
            "coll_bytes_per_dev": self.coll_bytes_per_dev,
            "coll_breakdown": self.coll_breakdown,
            "model_flops_global": self.model_flops_global,
            "chips": self.chips,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


# ---------------------------------------------------------------------------
# MODEL_FLOPS


def param_counts(cfg) -> tuple:
    """(total, active) parameter counts from the model schema."""
    from repro_torch.models.layers import ParamDef

    if getattr(cfg, "is_encdec", False):
        from repro_torch.models import encdec as mod
    else:
        from repro_torch.models import transformer as mod
    total = active = 0

    def walk(node):
        nonlocal total, active
        if isinstance(node, ParamDef):
            n = int(np.prod(node.shape))
            total += n
            # expert stacks carry the 'experts' logical axis
            if "experts" in node.axes and cfg.n_experts:
                active += n * cfg.top_k / cfg.n_experts
            else:
                active += n
            return
        for v in node.values():
            walk(v)

    walk(mod.model_schema(cfg))
    return int(total), int(active)


def model_flops(cfg, shape, kind: Optional[str] = None) -> float:
    """6·N_active·D (train) or 2·N_active·D (prefill/decode)."""
    total, active = param_counts(cfg)
    kind = kind or shape.kind
    if kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * active * tokens
    if kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * active * tokens
    # decode: one token per sequence per step
    return 2.0 * active * shape.global_batch


def count_flops(fn: Callable, *args, **kwargs) -> tuple:
    """(fn(*args, **kwargs), the FLOPs ``FlopCounterMode`` counted in the
    call, its backward included where the call runs one)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        out = fn(*args, **kwargs)
    return out, int(counter.get_total_flops())


def derive(fn: Callable, args: tuple, cfg, shape, chips: int = 1,
           counter: Any = None) -> RooflineTerms:
    """The terms of one call of ``fn(*args)`` on this card: its counted
    FLOPs, its inputs' and outputs' bytes, and the collective bytes that
    `counter` (the mesh's ``CommCounter``, or None off a mesh) gained in
    the call."""
    before = dict(counter.bytes) if counter is not None else {}
    out, flops = count_flops(fn, *args)
    coll = ({k: int(v - before.get(k, 0)) for k, v in counter.bytes.items()}
            if counter is not None else {})
    return RooflineTerms(
        flops_per_dev=float(flops),
        hbm_bytes_per_dev=float(bytes_of_tree(args) + bytes_of_tree(out)),
        coll_bytes_per_dev=sum(coll.values()),
        coll_breakdown=coll,
        model_flops_global=model_flops(cfg, shape),
        chips=chips,
    )
