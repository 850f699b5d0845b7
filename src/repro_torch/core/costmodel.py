"""The per-column-family placement cost model behind the ``hybrid`` lowering.

The port of the placement half of ``repro.core.costmodel``, with the same
arithmetic, so every modeled second equals the reference's.  Per column
family it compares the ISP roofline — max(stream the encoded pages, run the
chain at the ISP unit's compute rate) — against the host alternative — move
encoded pages in and train-ready tensors out over the link, then run at host
compute rate — and places the family wherever it finishes first.
Byte-heavy/compute-light chains (decode-dominated) favor ISP;
compute-heavy/byte-light chains (Bucketize's binary search over large
boundary tables) favor the host.  ``partition_costs`` sums one partition's
families for the engine's ``route_costs``.

The constants model the paper's deployment (a SmartSSD-class ISP unit and
CPU preprocessing servers), not the H100: they choose placements and price
routes, and no number here is a time on the card.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

from repro_torch.core import opgraph
from repro_torch.core.spec import TransformSpec


@dataclasses.dataclass(frozen=True)
class PlacementCostModel:
    """Bytes-moved vs compute roofline constants for one deployment.

    Defaults sketch a SmartSSD-class ISP unit behind a 25 Gb/s effective
    link to CPU preprocessing servers; they are deliberately round numbers —
    the *shape* of the decision (decode-heavy -> ISP, search-heavy -> host)
    is what the tests pin down, not the constants.
    """

    link_bytes_per_s: float = 3e9  # host hop: NIC, per direction
    isp_stream_bytes_per_s: float = 8e9  # SSD->FPGA internal stream
    isp_ops_per_s: float = 5e9  # ISP unit compute roofline
    host_ops_per_s: float = 100e9  # one provisioned CPU worker
    # fixed per-kernel-launch overhead (dispatch + program setup), the cost
    # a megabatched launch amortizes over its K partitions
    launch_overhead_s: float = 2e-4

    def megabatch_launch_s(self, per_partition_s: float, k: int) -> float:
        """Modeled seconds for ONE megabatched launch of K partitions."""
        return self.launch_overhead_s + max(k, 1) * per_partition_s

    def megabatch_amortization(self, per_partition_s: float, k: int) -> float:
        """Modeled speedup of one K-megabatch over K solo launches.

        K solo launches pay K overheads; the megabatch pays one.  This is
        the dispatch-amortization half of the zero-stall produce path (the
        other half, read/compute overlap, turns ``io + compute`` into
        ``max(io, compute)`` and is benched, not modeled)."""
        k = max(k, 1)
        solo = k * (self.launch_overhead_s + per_partition_s)
        return solo / self.megabatch_launch_s(per_partition_s, k)

    def predicted_megabatch_k(
        self,
        per_partition_s: float,
        k_max: int,
        *,
        rel_tolerance: float = 0.05,
        candidates=None,
    ) -> int:
        """The modeled optimum the online tuner seeds from: the smallest K
        (among ``candidates``, default 1..k_max) whose per-partition launch
        cost is within ``rel_tolerance`` of the best achievable — the knee
        of the ``megabatch_amortization`` curve.  Measured hill-climbing
        (``core.autotune.MegabatchTuner``) owns the final say; this just
        starts it near the right rung so convergence is cheap."""
        ks = sorted(
            {int(k) for k in (candidates or range(1, max(1, int(k_max)) + 1)) if int(k) >= 1}
        )
        if not ks:
            return 1
        if per_partition_s <= 0.0:
            return ks[-1]  # overhead-only: the biggest amortization wins
        cost = {k: self.megabatch_launch_s(per_partition_s, k) / k for k in ks}
        best = min(cost.values())
        for k in ks:
            if cost[k] <= best * (1.0 + rel_tolerance):
                return k
        return ks[-1]


DEFAULT_PLACEMENT_MODEL = PlacementCostModel()

# abstract op weights (ops per produced value) per operator kind; bucketize
# is a binary search so its weight is log2 of the boundary-table size.
_DECODE_OPS = 1.0
_LOGNORM_OPS = 2.0
_SIGRIDHASH_OPS = 8.0
_GATHER_OPS = 0.5  # dedup expand: one indexed copy per logical value


def family_compute_ops(spec: TransformSpec, rows: int) -> Dict[str, float]:
    """Abstract compute ops per family for one partition of `rows`.

    Dedup datasets (``cfg.dup_factor > 1``) decode + hash each shared sparse
    block ONCE (``rows / dup_factor`` unique rows) and pay a cheap gather op
    per logical value to expand back — the RecD savings axis the planner and
    router price through these numbers.
    """
    cfg = spec.cfg
    d = max(int(cfg.dup_factor), 1)
    u = rows // d
    bucket_ops = math.log2(max(cfg.bucket_size, 2))
    sparse_ops = u * cfg.n_sparse * cfg.max_sparse_len * (
        _DECODE_OPS + _SIGRIDHASH_OPS
    )
    length_ops = u * cfg.n_sparse * _DECODE_OPS
    if d > 1:  # gather-expand to logical rows inside the program
        sparse_ops += rows * cfg.n_sparse * cfg.max_sparse_len * _GATHER_OPS
        length_ops += rows * cfg.n_sparse * _GATHER_OPS
    return {
        "dense": rows * cfg.n_dense * (_DECODE_OPS + _LOGNORM_OPS),
        "sparse": sparse_ops,
        "gen": rows * cfg.n_generated
        * (_DECODE_OPS + bucket_ops + _SIGRIDHASH_OPS),
        "lengths": length_ops,
        "labels": rows * _DECODE_OPS,
    }


def placement_costs(
    spec: TransformSpec,
    rows: Optional[int] = None,
    model: PlacementCostModel = DEFAULT_PLACEMENT_MODEL,
) -> Dict[str, Dict[str, float]]:
    """Per family: modeled seconds under each placement ({family: {isp, host}})."""
    rows = rows or spec.cfg.rows_per_partition
    page_b = opgraph.family_page_bytes(spec, rows)
    out_b = opgraph.family_batch_bytes(spec, rows)
    ops = family_compute_ops(spec, rows)
    costs = {}
    for fam in opgraph.FAMILIES:
        isp = max(
            page_b[fam] / model.isp_stream_bytes_per_s,
            ops[fam] / model.isp_ops_per_s,
        )
        host = (page_b[fam] + out_b[fam]) / model.link_bytes_per_s + (
            ops[fam] / model.host_ops_per_s
        )
        costs[fam] = {"isp": isp, "host": host}
    return costs


def choose_placement(
    spec: TransformSpec,
    rows: Optional[int] = None,
    model: PlacementCostModel = DEFAULT_PLACEMENT_MODEL,
) -> Dict[str, str]:
    """The hybrid placement: each family goes wherever it finishes first."""
    return {
        fam: min(c, key=c.get) for fam, c in placement_costs(spec, rows, model).items()
    }


# ---------------------------------------------------------------------------
# Contention-aware routing (device-aware scheduling)


@dataclasses.dataclass(frozen=True)
class PartitionCosts:
    """Whole-partition cost summary for one Transform: the inputs the
    device-aware router and the device ledgers need, precomputed once per
    session instead of per claim."""

    isp_s: float  # modeled seconds on an idle ISP unit (all families)
    host_s: float  # modeled seconds via the host path (link + host compute)
    ops: float  # abstract Transform ops (charged to whoever computes)
    page_bytes: int  # encoded pages (host path: moved over the link, in)
    batch_bytes: int  # train-ready tensors (host path: moved back, out)

    @property
    def link_bytes(self) -> int:
        """Copy-in/copy-out traffic of one host-fallback produce."""
        return self.page_bytes + self.batch_bytes


def partition_costs(
    spec: TransformSpec,
    rows: Optional[int] = None,
    model: PlacementCostModel = DEFAULT_PLACEMENT_MODEL,
) -> PartitionCosts:
    """Aggregate ``placement_costs`` over every family of one partition."""
    rows = rows or spec.cfg.rows_per_partition
    per_family = placement_costs(spec, rows, model)
    page_b = opgraph.family_page_bytes(spec, rows)
    out_b = opgraph.family_batch_bytes(spec, rows)
    ops = family_compute_ops(spec, rows)
    return PartitionCosts(
        isp_s=sum(c["isp"] for c in per_family.values()),
        host_s=sum(c["host"] for c in per_family.values()),
        ops=sum(ops.values()),
        page_bytes=int(sum(page_b.values())),
        batch_bytes=int(sum(out_b.values())),
    )
