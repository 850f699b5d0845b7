"""TorchPreStoEngine: the ISP worker's unit of work, on one CUDA device.

The port of ``repro.core.presto.PreStoEngine``, under every placement
the reference takes: ``presto`` (every column family on the ISP unit,
three fused CUDA kernels), ``disagg`` (every family on the host),
``hybrid`` (the cost model's per-family choice) or a per-family dict.  A partition's encoded pages go to the device once and come
back as a train-ready mini-batch.  As in the reference, the placement says
which families' traffic would hop to a host, and ``kernel_mode`` (or, by
default, the placement) says how the Transform lowers: ``disagg`` alone
keeps the fused kernels; ``kernel_mode="unfused"`` lowers the multi-pass
plan of standalone kernels.

Meshed engines (``TorchPreStoEngine(spec, mesh)``, the port of the
reference's ``preprocess_global``) run one per rank of a
``launch.mesh.Mesh``: each rank holds its ``data`` block of a partition's
pages (``shard_pages``; replicated over ``model``), and
``preprocess_global`` turns it into the same block of the global batch.
ISP-placed families are local compute.  Host-placed families' pages hop +1
on ``data`` before the Transform and their batch keys hop -1 after
(``distributed.comm.ppermute``), the disaggregated pool's copy-in and
copy-out; when ``gen`` and ``dense`` both hop, ``gen_words`` is regathered
from the hopped dense pages instead of hopped, so ``disagg`` moves exactly
the four page arrays.  ``presto`` makes no collective call at all.

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

from repro_torch.common.util import resolve_device, span
from repro_torch.core.costmodel import DEFAULT_PLACEMENT_MODEL, partition_costs
from repro_torch.core.opgraph import (
    FAMILIES,
    FAMILY_BATCH_KEYS,
    FAMILY_PAGE_VALUES,
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
from repro_torch.data.columnar import inflate_partition
from repro_torch.data.storage import PartitionedStore
from repro_torch.distributed import comm
from repro_torch.distributed.sharding import gather, shard

# folded into cache_signature so a port engine never shares an identity with
# a JAX engine of the same spec and placement
BACKEND_TAG = "torch"

PLACEMENTS = ("presto", "disagg", "hybrid")

HostPages = Dict[str, torch.Tensor]  # int32 views, pinned on CUDA engines


def pages_pspec() -> Dict[str, tuple]:
    """Row-group axis of every page array is sharded over the data axis."""
    return {
        "dense_words": (None, "data", None),
        "sparse_words": (None, "data", None),
        "length_words": (None, "data", None),
        "label_words": ("data",),
    }


def minibatch_pspec() -> Dict[str, tuple]:
    return {
        "dense": ("data", None),
        "multi_hot_ids": ("data", None, None),
        "lengths": ("data", None),
        "one_hot_ids": ("data", None),
        "labels": ("data",),
    }


def shard_pages(pages: Dict[str, np.ndarray], mesh) -> Dict[str, np.ndarray]:
    """This rank's block of one partition's (classic) pages under
    ``pages_pspec``; raises where the data axis does not divide a page's
    row-group axis."""
    if "sparse_refs" in pages:
        raise ValueError("dedup pages shard only once inflated (stage_partition does it)")
    specs = pages_pspec()
    return {k: shard(v, mesh, specs[k]) for k, v in pages.items()}


def gather_minibatch(mb: MiniBatch, mesh) -> MiniBatch:
    """The global batch from every rank's block (``minibatch_pspec``)."""
    specs = minibatch_pspec()
    return {k: gather(v, mesh, specs[k]) for k, v in mb.items()}


class TorchPreStoEngine:
    """Owns a TransformSpec and runs its lowered plan on one device."""

    def __init__(
        self,
        spec: TransformSpec,
        mesh=None,
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
        kernels, as the reference does.  `mesh`: this rank's
        ``launch.mesh.Mesh`` for ``preprocess_global`` (the device then
        defaults to the rank's)."""
        if isinstance(placement, dict):
            family_placements, placement = dict(placement), "hybrid"
        if placement not in PLACEMENTS:
            raise ValueError(f"placement must be one of {PLACEMENTS} or a dict, got {placement!r}")
        self.spec = spec
        self.mesh = mesh
        if device is None and mesh is not None:
            device = mesh.device
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
        """Extract(Read): fetch + lay out one partition's pages (numpy).

        Meshed engines shard pages along the row-group axis
        (``pages_pspec``), which a dedup partition's unique-geometry pages
        would break: those inflate (``columnar.inflate_partition``, bitwise
        faithful) to the classic per-sample layout first.  The store still
        charges only the stored bytes."""
        part = store.read(pid)
        if self.mesh is not None:
            part = inflate_partition(part)
        return pages_from_partition(part, self.spec)

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
        """This rank's block of the global batch from its block of the
        pages (``shard_pages``, on the engine's device); with no mesh,
        ``preprocess_local``.

        Host-placed families' pages hop +1 on the data axis before the
        Transform and their mini-batch keys hop -1 after, so each rank's
        rows come back to it.  ``presto`` (no host family) makes no
        collective call."""
        if self.mesh is None:
            return self.preprocess_local(pages)
        if "sparse_refs" in pages:
            raise ValueError("a meshed engine takes inflated pages (stage_partition)")
        mesh, plan = self.mesh, self.lowered_plan
        host_fams = self.host_families()
        hop = bool(host_fams) and mesh.shape["data"] > 1
        env = prepare_env(pages, plan.gen_index)
        if hop:
            # when dense pages hop anyway, gen's source planes are
            # regathered from them on the far side instead of hopped
            skip_gen = "gen" in host_fams and "dense" in host_fams
            for fam in host_fams:
                if fam == "gen" and skip_gen:
                    continue
                for k in FAMILY_PAGE_VALUES[fam]:
                    env[k] = comm.ppermute(env[k], mesh, "data", 1)
            if skip_gen:
                env["gen_words"] = env["dense_words"].index_select(0, plan.gen_index)
        mb = plan.execute_env(env)
        if hop:
            for fam in host_fams:
                for k in FAMILY_BATCH_KEYS[fam]:
                    mb[k] = comm.ppermute(mb[k], mesh, "data", -1)
        return mb

    def preprocess_megabatch(self, stacked: Dict[str, torch.Tensor]) -> Tuple[MiniBatch, ...]:
        """Transform a leading-axis megabatch of K partitions in ONE launch
        per kernel, then split back into K per-partition mini-batches,
        bitwise identical to K solo runs (every stage is row-local).
        Mesh-less engines only: megabatching is a per-unit local launch."""
        if self.mesh is not None:
            raise ValueError("megabatching is a local (per-unit) launch; the engine has a mesh")
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
        ``produce_stream`` and the service's pool workers.

        Spans (``common.util.span``): ``engine.launch`` around the call,
        ``engine.copy_in`` around the copies enqueued and
        ``engine.transform`` around the kernels enqueued."""
        with span("engine.launch"), self._on_device():
            with span("engine.copy_in"):
                pages = self.put_pages(pinned)
            with span("engine.transform"):
                batches = self.preprocess_megabatch(pages)
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
        Returns once the batch is complete on the device.  A meshed engine
        returns this rank's block of the global batch."""
        if self.mesh is None:
            return self.produce_batches(store, [pid])[0]
        pinned = self.pin_pages(shard_pages(self.stage_partition(store, pid), self.mesh))
        with self._on_device():
            mb = self.preprocess_global(self.put_pages(pinned))
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
        return mb

    def produce_batches(
        self, store: PartitionedStore, pids: Sequence[int]
    ) -> List[MiniBatch]:
        """Extract + Transform K partitions with ONE megabatched launch per
        kernel; bitwise identical to K ``produce_batch`` calls.  A plan with
        a non-row-local stage, or a meshed engine, runs them solo instead."""
        pids = list(pids)
        if self.mesh is not None or (len(pids) > 1 and not self.lowered_plan.megabatch_safe()):
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
        calls either way.  Mesh-less engines only."""
        if self.mesh is not None:
            raise ValueError("produce_stream is a per-unit local loop; the engine has a mesh")
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
