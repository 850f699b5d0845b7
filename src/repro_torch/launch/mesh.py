"""Meshes of ranks over ``torch.distributed``, and the launcher that runs
one program on every rank.

The port of ``repro.launch.mesh``.  The reference lays a logical mesh over
the devices of one JAX process; the port runs one process per mesh
position (a rank), numbered row-major over the mesh's shape, so that
``rank = ravel(coords)`` as in the reference's device order.

Single pod : (16, 16) = 256 ranks, axes (data, model)
Multi pod  : (2, 16, 16) = 512 ranks, axes (pod, data, model); ``pod`` is
             the outer pure-DP axis.

``make_mesh`` builds one process group per axis slice over an initialised
world and picks the transport from the rank -> device map
(``rank_devices``):

* ``nccl``        every rank has a CUDA device of its own;
* ``gloo``        CPU ranks;
* ``gloo-staged`` ranks share a CUDA device: NCCL refuses two ranks on one
                  device, so every operand is staged through a pinned host
                  buffer and moved by gloo.

It chooses from the map alone, never by trying one and catching its error,
and raises when the map allows neither (a mix of CPU and CUDA ranks, or a
backend this PyTorch was built without).  ``run_spmd`` spawns the ranks
(the ``spawn`` start method: CUDA cannot be forked once initialised),
meets them through a ``file://`` store in a fresh temporary directory (no
fixed port), and raises if any rank raises.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.common.util import resolve_device
from repro_torch.distributed.comm import CommCounter

COLLECTIVE_TIMEOUT_S = 300  # a rank waiting on a dead peer raises after this
EXIT_GRACE_S = 5.0  # an exited rank's result has this long to reach the parent


def rank_devices(world: int, device: torch.device) -> List[torch.device]:
    """The device of each rank: the CPU, or CUDA device ``rank % count``
    (several ranks share a card when the world outnumbers the cards)."""
    if device.type == "cpu":
        return [torch.device("cpu")] * world
    n = torch.cuda.device_count()
    return [torch.device("cuda", r % n) for r in range(world)]


def choose_transport(devices: Sequence[torch.device]) -> str:
    """The transport for a rank -> device map, or a ValueError."""
    kinds = {d.type for d in devices}
    if kinds == {"cpu"}:
        transport = "gloo"
    elif kinds == {"cuda"}:
        distinct = len({d.index for d in devices}) == len(devices)
        transport = "nccl" if distinct else "gloo-staged"
    else:
        raise ValueError(f"ranks on {sorted(kinds)}: a mesh runs on one kind of device")
    available = dist.is_nccl_available() if transport == "nccl" else dist.is_gloo_available()
    if not available:
        raise ValueError(f"transport {transport} is not built into this PyTorch")
    return transport


def backend_of(transport: str) -> str:
    return "nccl" if transport == "nccl" else "gloo"


@dataclasses.dataclass
class Mesh:
    """This rank's view of a mesh: the axes, this rank's coordinates, the
    process group of each axis through this rank, and the byte counter of
    ``distributed.comm``.  ``shape`` maps axis -> size in axis order, as
    the reference's ``Mesh.shape`` does."""

    shape: Dict[str, int]
    rank: int
    device: torch.device
    transport: str
    groups: Dict[str, Any] = dataclasses.field(default_factory=dict)
    group_ranks: Dict[str, List[int]] = dataclasses.field(default_factory=dict)
    counter: CommCounter = dataclasses.field(default_factory=CommCounter)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    @property
    def coords(self) -> Dict[str, int]:
        return self.coords_of(self.rank)

    def coords_of(self, rank: int) -> Dict[str, int]:
        """The coordinates of `rank` (row-major over the mesh's shape)."""
        out, r = {}, rank
        for axis in reversed(self.axis_names):
            out[axis] = r % self.shape[axis]
            r //= self.shape[axis]
        return {a: out[a] for a in self.axis_names}

    @property
    def staged(self) -> bool:
        return self.transport == "gloo-staged"


@dataclasses.dataclass(frozen=True)
class World:
    """A world of ranks to spawn: the mesh's shape and axes and the ranks'
    device kind (CUDA unless named).  ``run`` is ``run_spmd`` over it."""

    shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    device: Any = None

    def run(self, fn: Callable, *, args: tuple = (), timeout: float = 900.0) -> List[Any]:
        return run_spmd(fn, self.shape, self.axes, device=self.device, args=args,
                        timeout=timeout)


def axis_ranks(shape: Sequence[int], axis: int) -> List[List[int]]:
    """The ranks of every slice along mesh axis `axis`, each in axis order;
    slices in row-major order of the other coordinates."""
    ranks = torch.arange(math.prod(shape)).reshape(tuple(shape))
    moved = ranks.movedim(axis, -1).reshape(-1, shape[axis])
    return [[int(r) for r in row] for row in moved]


def make_mesh(shape, axes, *, device: torch.device | str | None = None) -> Mesh:
    """This rank's mesh over the initialised world (``init_world``), whose
    size must be the product of `shape`.  Every rank must call it with the
    same shape and axes: it creates every axis's groups in one order."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in length")
    world, rank = dist.get_world_size(), dist.get_rank()
    if math.prod(shape) != world:
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks, the world has {world}")
    device = resolve_device(device)
    transport = choose_transport(rank_devices(world, device))
    if backend_of(transport) != dist.get_backend():
        raise ValueError(f"the world runs {dist.get_backend()}, the mesh needs {transport}")
    mesh = Mesh(dict(zip(axes, shape)), rank, rank_devices(world, device)[rank], transport)
    for i, axis in enumerate(axes):
        for ranks in axis_ranks(shape, i):
            group = dist.new_group(ranks, backend=backend_of(transport))
            if rank in ranks:
                mesh.groups[axis], mesh.group_ranks[axis] = group, ranks
    return mesh


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def make_host_mesh(shape=None, axes=None, *, device=None) -> Mesh:
    """Small mesh over whatever ranks exist (tests / examples), with the
    reference's default shapes for the world's size."""
    n = dist.get_world_size()
    if shape is None:
        if n >= 8:
            shape, axes = (2, 2, n // 4), ("pod", "data", "model")
        elif n >= 4:
            shape, axes = (2, n // 2), ("data", "model")
        else:
            shape, axes = (1, n), ("data", "model")
    return make_mesh(shape, axes, device=device)


def init_world(rank: int, world: int, store_path: str, device: torch.device) -> str:
    """Join the world of `world` ranks through the file at `store_path`,
    with the backend of the transport the rank -> device map calls for.
    Returns the transport."""
    devices = rank_devices(world, device)
    transport = choose_transport(devices)
    if devices[rank].type == "cuda":
        torch.cuda.set_device(devices[rank])
    dist.init_process_group(
        backend_of(transport), init_method=f"file://{store_path}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S),
        # NCCL binds the rank's communicators to its own card
        device_id=devices[rank] if transport == "nccl" else None,
    )
    return transport


def _rank_main(rank, world, store_path, shape, axes, device, fn, args, results, threads):
    """One rank: join the world, build the mesh, run fn(mesh, *args) and
    post ("ok", result) or ("error", traceback) to the parent."""
    try:
        torch.set_num_threads(threads)
        init_world(rank, world, store_path, device)
        mesh = make_mesh(shape, axes, device=device)
        value = fn(mesh, *args)
        dist.barrier()  # no rank leaves while a peer may still call it
        results.put((rank, "ok", value))
    except BaseException:  # posted to the parent, which raises it
        results.put((rank, "error", traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_spmd(
    fn: Callable,
    shape,
    axes,
    *,
    device: torch.device | str | None = None,
    args: tuple = (),
    timeout: float = 900.0,
) -> List[Any]:
    """Run ``fn(mesh, *args)`` on every rank of a `shape` mesh and return
    the ranks' results in rank order.

    `fn` and `args` travel to the ranks by pickling (a module-level
    function; tensors on the host), and so do the results.  `device` is
    the device kind of the ranks (CUDA unless named; ``rank_devices``
    places them).  Raises if any rank raises, dies, or has not answered
    within `timeout` seconds; the other ranks are then stopped."""
    device = resolve_device(device)
    world = math.prod(int(s) for s in shape)
    choose_transport(rank_devices(world, device))  # raise before spawning
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="repro_torch_mesh_")
    results = ctx.Queue()
    threads = max(1, (os.cpu_count() or 1) // world)
    procs = [
        ctx.Process(
            target=_rank_main, daemon=True,
            args=(r, world, os.path.join(tmp, "rendezvous"), tuple(shape), tuple(axes),
                  device, fn, args, results, threads),
        )
        for r in range(world)
    ]
    out: Dict[int, Any] = {}
    errors: List[str] = []
    reported: set = set()  # ranks named by an entry of `errors`
    exited: Dict[int, float] = {}  # rank -> when it was first seen exited
    killed: List[str] = []
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while len(out) < world and not errors:
            try:
                rank, status, value = results.get(timeout=0.5)
            except queue.Empty:
                now = time.monotonic()
                for r, p in enumerate(procs):
                    if p.exitcode is not None and r not in out:
                        exited.setdefault(r, now)
                # a result may still be in the pipe when its rank has exited
                dead = [r for r, t in exited.items() if r not in out and now - t > EXIT_GRACE_S]
                if dead:
                    errors.append(f"rank(s) {dead} exited without a result "
                                  f"(exit codes {[procs[r].exitcode for r in dead]})")
                    reported.update(dead)
                elif now > deadline:
                    errors.append(f"no result from rank(s) "
                                  f"{sorted(set(range(world)) - set(out))} in {timeout} s")
                continue
            if status == "ok":
                out[rank] = value
            else:
                errors.append(f"rank {rank} raised:\n{value}")
                reported.add(rank)
        # a rank's failure makes its peers fail too, and their reports may
        # reach the queue first: gather what the others post for a while
        end = time.monotonic() + EXIT_GRACE_S
        while errors and time.monotonic() < end:
            try:
                rank, status, value = results.get(timeout=0.2)
            except queue.Empty:
                continue
            if status != "ok":
                errors.append(f"rank {rank} raised:\n{value}")
                reported.add(rank)
        # a rank killed by a signal posts nothing, and its peers' errors
        # (a closed connection) say nothing of why
        killed = [f"rank {r} exited with code {p.exitcode} without a report"
                  + (f" (killed by signal {-p.exitcode})" if p.exitcode < 0 else "")
                  for r, p in enumerate(procs)
                  if errors and r not in out and r not in reported and p.exitcode]
    finally:
        for p in procs:
            if errors:
                p.terminate()
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if errors:
        # the first report last, and a killed rank after it: the end of a
        # long log shows the cause, not a peer's closed connection
        raise RuntimeError("run_spmd: the first failure last\n"
                           + "\n".join(errors[::-1] + killed))
    return [out[r] for r in range(world)]
