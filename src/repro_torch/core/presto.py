"""TorchPreStoEngine: the ISP worker's unit of work, on one CUDA device.

The port of the local (mesh-less) half of ``repro.core.presto.PreStoEngine``,
under every placement the reference takes on one device: ``presto`` (every
column family on the ISP unit, three fused CUDA kernels), ``disagg`` (every
family on the host), ``hybrid`` (the cost model's per-family choice) or a
per-family dict.  A partition's encoded pages go to the device once and come
back as a train-ready mini-batch.  As in the reference, the placement says
which families' traffic would hop to a host, and ``kernel_mode`` (or, by
default, the placement) says how the Transform lowers: ``disagg`` alone
keeps the fused kernels; ``kernel_mode="unfused"`` lowers the multi-pass
plan of standalone kernels.  This package has no meshed hops: host
families run on the engine's own device.

Produce path: the host reads a partition and builds its numpy pages, copies
them into pinned memory, and the device copies them in with
``non_blocking=True`` on the current stream, where the kernels then run.
Nothing synchronises until delivery, which waits on one CUDA event per
chunk: ``launch`` dispatches a staged chunk of K >= 1 partitions and returns
its batches with the event, ``deliver`` waits on it.  That pair is the one
dispatch path of ``produce_batches``, ``produce_stream`` and the service's
pool workers (``core.service``).  ``produce_stream`` stages the next chunk
(read, page build, pin) on a thread while the current chunk's copies and
kernels run.

The port has no jit, so nothing is compiled or shared between engines:
each engine runs its own lowered plan, and the reference's process-wide
executable registry (``repro.core.execcache``) has no counterpart here.
Each produce call selects the engine's device, so loader threads
(``data.loader.PrefetchLoader``) may call ``produce_batch`` concurrently;
each call stages into its own pinned buffers and waits on its own event.

Pinned buffers come from PyTorch's caching host allocator, which records an
event on the stream of each non-blocking copy out of a block and does not
hand the block out again before that event completes — so a staging buffer
is never refilled under a copy still reading it.  Copies and kernels share
one stream, so the caching device allocator never recycles a page tensor
under a kernel that still reads it.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.common.util import resolve_device
from repro_torch.core.costmodel import DEFAULT_PLACEMENT_MODEL, partition_costs
from repro_torch.core.opgraph import (
    FAMILIES,
    HOST,
    ISP,
    LoweredPlan,
    build_transform_graph,
    lower,
    prepare_env,
    resolve_placements,
)
from repro_torch.core.preprocess import (
    MiniBatch,
    ShapeDtype,
    execute_plan,
    flatten_megabatch,
    pages_from_partition,
    pages_shape_dtypes,
    stack_pages,
)
from repro_torch.core.spec import TransformSpec
from repro_torch.data.storage import PartitionedStore

# folded into cache_signature so a port engine never shares an identity with
# a JAX engine of the same spec and placement
BACKEND_TAG = "torch"

PLACEMENTS = ("presto", "disagg", "hybrid")

HostPages = Dict[str, torch.Tensor]  # int32 views, pinned on CUDA engines


class TorchPreStoEngine:
    """Owns a TransformSpec and runs its lowered plan on one device."""

    def __init__(
        self,
        spec: TransformSpec,
        *,
        placement="presto",
        kernel_mode: Optional[str] = None,
        family_placements: Optional[Dict[str, str]] = None,
        device: torch.device | str | None = None,
    ):
        """`placement`: "presto", "disagg", "hybrid", or a per-family dict
        (which means "hybrid" with those families' placements).  For
        "hybrid", `family_placements` overrides the cost model.
        `kernel_mode`: "fused"/"unfused" (or any mode ``resolve_placements``
        takes) forces the kernel lowering whatever the placement; None
        follows the placement, except that "disagg" keeps the fused
        kernels, as the reference does."""
        if isinstance(placement, dict):
            family_placements, placement = dict(placement), "hybrid"
        if placement not in PLACEMENTS:
            raise ValueError(f"placement must be one of {PLACEMENTS} or a dict, got {placement!r}")
        self.spec = spec
        self.device = resolve_device(device)
        self.placement = placement
        if placement == "hybrid":
            self.family_placements = resolve_placements(
                family_placements if family_placements is not None else "hybrid",
                spec,
            )
        else:
            uniform = ISP if placement == "presto" else HOST
            self.family_placements = {f: uniform for f in FAMILIES}
        self.kernel_mode = kernel_mode
        if kernel_mode is not None:
            kernel_placements = resolve_placements(kernel_mode, spec)
        elif placement == "disagg":
            # disagg moves the batch but still runs the fused kernels
            kernel_placements = resolve_placements("fused", spec)
        else:
            kernel_placements = self.family_placements
        self.lowered_plan: LoweredPlan = lower(
            build_transform_graph(spec), spec, kernel_placements, device=self.device,
        )

    def host_families(self) -> Tuple[str, ...]:
        """Families whose traffic the placement sends to a host."""
        return tuple(f for f in FAMILIES if self.family_placements[f] == HOST)

    def cache_signature(self) -> str:
        """Stable identity of this engine's Transform: the lowered plan's
        structural hash (equal to the JAX package's for the same spec,
        placement and kernel mode), the per-family placements, and the
        backend tag."""
        h = hashlib.sha256()
        h.update(self.lowered_plan.structural_hash().encode())
        h.update(json.dumps(sorted(self.family_placements.items())).encode())
        h.update(BACKEND_TAG.encode())
        return h.hexdigest()[:16]

    def route_costs(self, rows: Optional[int] = None, model=None):
        """Whole-partition cost summary (``costmodel.PartitionCosts``) for
        a claim router: modeled seconds on an idle ISP unit against the host
        path, plus the ops and link bytes per produce.  Routing consumes
        these; it never changes the produced bytes."""
        return partition_costs(
            self.spec, rows, model if model is not None else DEFAULT_PLACEMENT_MODEL
        )

    # -- staging (host) -------------------------------------------------------
    def stage_partition(self, store: PartitionedStore, pid: int) -> Dict[str, np.ndarray]:
        """Extract(Read): fetch + lay out one partition's pages (numpy)."""
        return pages_from_partition(store.read(pid), self.spec)

    def stage_megabatch(
        self, store: PartitionedStore, pids: Sequence[int]
    ) -> Dict[str, np.ndarray]:
        """Extract(Read) K partitions and stack their pages leading-axis;
        each read charges its own partition's bytes."""
        return stack_pages(self.stage_partition(store, pid) for pid in pids)

    def pin_pages(self, pages: Dict[str, np.ndarray]) -> HostPages:
        """Numpy uint32 pages -> int32 tensors, pinned for async copy when the
        engine runs on CUDA (views of the numpy arrays on the CPU)."""
        out = {}
        for k, v in pages.items():
            v = np.ascontiguousarray(v)
            if not v.flags.writeable:  # a view of a file's bytes (labels)
                v = v.copy()
            t = torch.from_numpy(v.view(np.int32))
            out[k] = t.pin_memory() if self.device.type == "cuda" else t
        return out

    def put_pages(self, pages: HostPages) -> Dict[str, torch.Tensor]:
        """Host page tensors -> the engine's device, without blocking."""
        if self.device.type == "cpu":
            return pages
        return {k: v.to(self.device, non_blocking=True) for k, v in pages.items()}

    # -- Transform (device) -----------------------------------------------------
    def preprocess_local(self, pages: Dict[str, torch.Tensor]) -> MiniBatch:
        """One partition's staged pages (on the engine's device) -> its
        mini-batch.  Dedup pages (carrying ``sparse_refs``) run the sparse
        chain at unique-block geometry and gather-expand on the card
        (``preprocess.execute_plan``), bitwise identical to classic pages."""
        return execute_plan(self.lowered_plan, pages)

    def preprocess_global(self, pages: Dict[str, torch.Tensor]) -> MiniBatch:
        """The global batch of the reference's meshed path, on one device:
        with no mesh the reference runs ``preprocess_local``, and so does
        this engine (the meshed hops of host families are not ported)."""
        return self.preprocess_local(pages)

    def preprocess_megabatch(self, stacked: Dict[str, torch.Tensor]) -> Tuple[MiniBatch, ...]:
        """Transform a leading-axis megabatch of K partitions in ONE launch
        per kernel, then split back into K per-partition mini-batches,
        bitwise identical to K solo runs (every stage is row-local)."""
        k = int(stacked["label_words"].shape[0])
        if k > 1 and not self.lowered_plan.megabatch_safe():
            raise ValueError(
                "lowered plan has a non-row-local stage; a megabatch would not "
                "be bitwise identical to solo runs"
            )
        mb = execute_plan(self.lowered_plan, flatten_megabatch(stacked))
        if k == 1:
            return (mb,)
        rows = mb["labels"].shape[0] // k
        split = {key: torch.split(v, rows, dim=0) for key, v in mb.items()}
        return tuple({key: split[key][i] for key in mb} for i in range(k))

    def _preprocess_rest(self, pages: Dict[str, torch.Tensor]) -> MiniBatch:
        """Partial Transform: every family EXCEPT sparse/lengths, from the
        dense and label pages alone.  Under ``presto`` it launches
        ``fused_dense`` and ``fused_gen`` and no sparse kernel."""
        plan = self.lowered_plan
        env = prepare_env(pages, plan.gen_index)
        for st in plan.stages:
            if st.family in ("sparse", "lengths") or st.name == "form_batch":
                continue
            env.update(zip(st.outputs, st.fn(*(env[k] for k in st.inputs))))
        # exactly form_batch's expressions for these keys
        return {
            "dense": env["dense_norm"].t().contiguous(),
            "one_hot_ids": env["gen_hashed"].t().contiguous(),
            "labels": env["labels_f32"].contiguous(),
        }

    def _on_device(self):
        """Select the engine's device for the calling thread."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def launch(self, pinned: HostPages) -> Tuple[Tuple[MiniBatch, ...], Optional[torch.cuda.Event]]:
        """Dispatch one staged chunk: copy its pinned, leading-axis stacked
        pages in (K >= 1 partitions, K = 1 included) and queue its kernels
        on the device's current stream, without blocking.  Returns the K
        batches and the event that marks them done (None on the CPU, where
        the batches are complete on return); ``deliver`` waits on it.  The
        one dispatch pair of every producer: ``produce_batches``,
        ``produce_stream`` and the service's pool workers."""
        with self._on_device():
            batches = self.preprocess_megabatch(self.put_pages(pinned))
            if self.device.type == "cpu":
                return batches, None
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
        return batches, done

    @staticmethod
    def deliver(done: Optional[torch.cuda.Event]) -> None:
        """Block the calling thread until a ``launch``'s batches are
        complete on the device."""
        if done is not None:
            done.synchronize()

    # -- produce path -------------------------------------------------------------
    def produce_batch(self, store: PartitionedStore, pid: int) -> MiniBatch:
        """Extract + Transform one partition into a device-ready mini-batch.
        Returns once the batch is complete on the device."""
        return self.produce_batches(store, [pid])[0]

    def produce_batches(
        self, store: PartitionedStore, pids: Sequence[int]
    ) -> List[MiniBatch]:
        """Extract + Transform K partitions with ONE megabatched launch per
        kernel; bitwise identical to K ``produce_batch`` calls.  A plan with
        a non-row-local stage runs them solo instead."""
        pids = list(pids)
        if len(pids) > 1 and not self.lowered_plan.megabatch_safe():
            return [self.produce_batch(store, pid) for pid in pids]
        batches, done = self.launch(self.pin_pages(self.stage_megabatch(store, pids)))
        self.deliver(done)
        return list(batches)

    def produce_stream(
        self,
        store: PartitionedStore,
        pids: Iterable[int],
        *,
        megabatch: int = 1,
        overlap: bool = True,
        lookahead: int = 1,
    ) -> Iterator[Tuple[int, MiniBatch]]:
        """The zero-stall produce loop: megabatched launches, double-buffered.

        Yields ``(pid, mini-batch)`` in `pids` order.  Partitions are
        grouped into megabatches of up to ``megabatch`` (1 for a plan with a
        non-row-local stage); each group's kernels run once.  With
        ``overlap`` the next ``lookahead`` groups are read, page-built and
        pinned on a staging thread while the current group's copies and
        kernels run, and the host waits on the group's event only at
        delivery.  Batches are bitwise identical to serial ``produce_batch``
        calls either way."""
        pids = list(pids)
        k = max(1, int(megabatch))
        if k > 1 and not self.lowered_plan.megabatch_safe():
            k = 1
        chunks = [pids[i : i + k] for i in range(0, len(pids), k)]
        if not chunks:
            return
        lookahead = max(1, int(lookahead))

        def stage(chunk):
            return self.pin_pages(self.stage_megabatch(store, chunk))

        if not overlap:
            for chunk in chunks:
                batches, done = self.launch(stage(chunk))
                self.deliver(done)
                yield from zip(chunk, batches)
            return
        with ThreadPoolExecutor(max_workers=1, thread_name_prefix="presto-stage") as stager:
            pending: List = []  # staged-chunk futures, window of `lookahead`
            nxt = 0

            def top_up() -> None:
                nonlocal nxt
                while len(pending) < lookahead and nxt < len(chunks):
                    pending.append(stager.submit(stage, chunks[nxt]))
                    nxt += 1

            top_up()
            for chunk in chunks:
                batches, done = self.launch(pending.pop(0).result())
                top_up()  # refill behind the in-flight copies and kernels
                self.deliver(done)  # block only at delivery
                yield from zip(chunk, batches)

    def pages_struct(self, rows: int) -> Dict[str, ShapeDtype]:
        """Shapes and dtypes of one partition's page tensors on the device."""
        return pages_shape_dtypes(self.spec, rows)

    # -- block-granularity cache hooks (dedup datasets) -------------------------
    #
    # A dedup partition's train-ready sparse content is fully determined by
    # its unique blocks: rows sharing a block have identical multi_hot_ids /
    # lengths slices.  ``extract_blocks`` pulls those per-block slices out of
    # a produced batch (publish side, to the host once) and
    # ``assemble_from_blocks`` rebuilds a full batch from cached blocks plus
    # the rest program (``_preprocess_rest``) over the per-sample families
    # (dense/gen/labels), gathering the blocks through the refs on the
    # device — bitwise a cold produce of the same partition.

    @staticmethod
    def extract_blocks(batch: MiniBatch, refs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Per-unique-block hashed sparse content of a produced batch, on the
        host: ``(ids (u, S, L) i32, lens (u, S) i32)``.  Block b's slice is
        the first row r with ``refs[r] == b`` (all such rows are equal)."""
        _, first = np.unique(np.asarray(refs), return_index=True)
        idx = torch.from_numpy(first).to(batch["multi_hot_ids"].device)
        ids = batch["multi_hot_ids"].index_select(0, idx).cpu().numpy()
        lens = batch["lengths"].index_select(0, idx).cpu().numpy()
        return ids, lens

    def assemble_from_blocks(
        self,
        pages: Dict[str, np.ndarray],
        block_ids: np.ndarray,
        block_lens: np.ndarray,
    ) -> MiniBatch:
        """Full batch from cached sparse blocks + the rest program.

        ``pages`` is dedup-staged (``stage_partition``) output, its refs
        already checked against the partition's blocks; only its dense and
        label pages go to the device — the sparse pages' decode and hash is
        the work the block cache saved.  The blocks are copied in and
        gathered through the refs on the device.  Returns once the batch is
        complete; bitwise identical to a cold produce of the partition."""
        refs = np.asarray(pages["sparse_refs"], dtype=np.int64)
        n_blocks = len(block_ids)
        if len(block_lens) != n_blocks or (
            refs.size and (refs.min() < 0 or refs.max() >= n_blocks)
        ):
            raise ValueError(
                f"refs outside the {n_blocks} cached block(s) "
                f"({len(block_lens)} length rows)"
            )
        rest = self.pin_pages(
            {"dense_words": pages["dense_words"], "label_words": pages["label_words"]}
        )
        with self._on_device():
            batch = self._preprocess_rest(self.put_pages(rest))
            idx = torch.from_numpy(refs).to(self.device)
            batch["multi_hot_ids"] = torch.as_tensor(block_ids).to(self.device).index_select(0, idx)
            batch["lengths"] = torch.as_tensor(block_lens).to(self.device).index_select(0, idx)
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
        return batch
