"""Fault-tolerant checkpointing: atomic, async, in the reference's format.

The port of ``repro.train.checkpoint``.  Layout (one directory per step):

    <root>/step_000123.tmp/      — written first
        MANIFEST.json            — step, leaf paths, shapes, dtypes
        <leafpath>.npy           — one file per leaf (full array)
    <root>/step_000123/          — atomic rename once all leaves are synced

The leaves and their paths are the reference's: a TrainState
``{params: DLRM, opt: {m, v, count}, step}`` flattens in sorted-key order
to ``opt/count``, ``opt/m/<group>/<name>``, ``opt/v/...``,
``params/<group>/<name>``, ``params/tables`` and ``step`` (a parameter
named ``bottom.w0`` is the reference's ``bottom/w0``), so for the same
state both packages write the same bytes, and each restores the other's
checkpoints.

Where the port differs, and why:

* ``save`` copies every leaf to the host before it returns; only the file
  writes run on the background thread.  The reference can hand its
  immutable arrays to the thread, but the port's train step updates the
  parameters and the AdamW moments in place, so a leaf read later would
  hold a later step's values.
* ``restore`` fills the target's own tensors in place, leaf by leaf, and
  returns the target.  Each ``.npy`` is memory-mapped and copied in chunks
  of at most ``CHUNK_BYTES``, so the host holds one chunk at a time and the
  device no second state: at RM2 width the state with its gradients takes
  60.1 GiB of the card's 79.2, and a restore that built a second state
  could not fit.  A leaf whose shape or dtype differs from the target's
  raises, naming the leaf.

Sharded state (every rank of a ``launch.mesh`` world holds its blocks, as
``distributed.sharding.shard`` cuts them under a spec tree such as
``train.step.state_shardings``) is saved and restored in the same global
format, so a checkpoint carries no topology, as the reference's does:

* ``save(step, state, mesh=, specs=)`` is called by every rank.  Leaf by
  leaf, the ranks that hold distinct blocks send them to rank 0 in chunks
  of at most ``CHUNK_BYTES``; rank 0 places them in one host array of the
  global shape, writes it as the reference's ``.npy`` and drops it, so it
  holds at most one full leaf beyond the state.  The files are the bytes
  of a one-device save of the global state.  A meshed save is synchronous:
  every rank waits at a barrier after rank 0's atomic rename, so once
  ``save`` returns on any rank, every rank's ``latest_step()`` sees it.
* ``restore(step, target=, mesh=, specs=)`` fills each rank's blocks: the
  rank maps each ``.npy`` and copies only its block, chunk by chunk.  It
  reads a checkpoint written by any mesh, by one device or by the
  reference, and a meshed save restores on one device.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from repro_torch.distributed import comm
from repro_torch.distributed.sharding import block_index, spec_axes, spec_size

_STEP_RE = re.compile(r"^step_(\d{9})$")
CHUNK_BYTES = 1 << 28  # 256 MB: one RM2 table (16.1 GB) is 61 chunks


def _children(node: Any) -> Optional[Dict[str, Any]]:
    """A node's children by key, or None for a leaf.  Dotted names nest, as
    the reference's nested dicts do: a module's parameter ``bottom.w0`` and
    the AdamW moment of the same name are the child ``w0`` of ``bottom``."""
    if isinstance(node, nn.Module):
        items = node.named_parameters()
    elif isinstance(node, dict):
        items = node.items()
    else:
        return None
    tree: Dict[str, Any] = {}
    for name, value in items:
        *groups, leaf = str(name).split(".")
        d = tree
        for g in groups:
            d = d.setdefault(g, {})
        d[leaf] = value
    return tree


def flatten_state(state: Any) -> List[Tuple[str, torch.Tensor]]:
    """``(path, tensor)`` for every leaf, in the order and with the paths of
    the reference's ``tree_flatten_with_path`` (dict keys sorted at every
    level)."""
    out: List[Tuple[str, torch.Tensor]] = []

    def walk(node: Any, prefix: str) -> None:
        kids = _children(node)
        if kids is None:
            out.append((prefix, node))
            return
        for key in sorted(kids):
            walk(kids[key], f"{prefix}/{key}" if prefix else str(key))

    walk(state, "")
    return out


def _host_copy(t: torch.Tensor) -> np.ndarray:
    """A host array that no later in-place update can reach."""
    return t.detach().to("cpu", copy=True).numpy()


def chunk_index(shape, itemsize: int) -> Iterator[tuple]:
    """Index tuples that cut an array of `shape` along its leading axes into
    pieces of at most ``CHUNK_BYTES`` (one element at least): runs of whole
    rows where a row fits, else row by row, and a 1-d run by elements."""
    limit = CHUNK_BYTES

    def walk(prefix: tuple, shape: tuple):
        if not shape or math.prod(shape) * itemsize <= limit:
            yield prefix
            return
        row = math.prod(shape[1:]) * itemsize
        if row > limit:
            for i in range(shape[0]):
                yield from walk(prefix + (i,), shape[1:])
            return
        step = limit // row
        for start in range(0, shape[0], step):
            yield prefix + (slice(start, min(start + step, shape[0])),)

    yield from walk((), tuple(shape))


def leaf_chunks(arr: np.ndarray, dst: torch.Tensor) -> Iterator[Tuple[np.ndarray, torch.Tensor]]:
    """Matching chunks of a (memory-mapped, possibly strided) array and a
    tensor of its shape, each of at most ``CHUNK_BYTES``."""
    for idx in chunk_index(arr.shape, arr.itemsize):
        yield arr[idx], dst[idx]


def _place(block: tuple, idx: tuple) -> tuple:
    """The global index of chunk `idx` of the block at slices `block`."""
    out = list(block)
    for d, i in enumerate(idx):
        start = block[d].start
        out[d] = start + i if isinstance(i, int) else slice(start + i.start, start + i.stop)
    return tuple(out)


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype


def gather_leaf(t: torch.Tensor, mesh, spec: tuple) -> Optional[np.ndarray]:
    """The global leaf of every rank's block `t` under `spec`, on rank 0's
    host (None on the other ranks).  One rank of each distinct block (the
    one at coordinate 0 on every axis the spec does not shard over) sends
    it to rank 0 in chunks of at most ``CHUNK_BYTES``; a replicated leaf
    moves nothing.  Every rank must call it, leaf by leaf in one order."""
    gshape = tuple(n * spec_size(mesh, spec[d]) if d < len(spec) else n
                   for d, n in enumerate(t.shape))
    free = [a for a in mesh.axis_names if a not in spec_axes(spec)]
    out = np.empty(gshape, _np_dtype(t.dtype)) if mesh.rank == 0 else None
    itemsize = t.element_size()
    for r in range(math.prod(mesh.shape.values())):
        coords = mesh.coords_of(r)
        if any(coords[a] for a in free) or mesh.rank not in (0, r):
            continue
        block = block_index(gshape, mesh, spec, coords)
        for idx in chunk_index(tuple(t.shape), itemsize):
            if r == mesh.rank == 0:
                out[_place(block, idx)] = _host_copy(t[idx])
            elif mesh.rank == r:
                comm.send(t[idx].detach(), mesh, 0)
            else:
                like = torch.empty(t[idx].shape, dtype=t.dtype, device=mesh.device)
                out[_place(block, idx)] = comm.recv(like, mesh, r).cpu().numpy()
    return out


def _spec_of(specs: Any) -> Dict[str, tuple]:
    """A spec tree (the state's structure, spec tuples as leaves) by leaf
    path."""
    return dict(flatten_state(specs))


class CheckpointManager:
    def __init__(self, root: str, *, keep: int = 3, async_save: bool = True):
        self.root = root
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        # the last save: step, bytes, and the seconds of the host snapshot
        # and of the file writes (write_s is set when the writes end)
        self.last_save: Dict[str, Any] = {}
        os.makedirs(root, exist_ok=True)
        if not dist.is_initialized() or dist.get_rank() == 0:
            self._gc_tmp()  # on a mesh rank 0 writes: another rank's tmp is its save

    # -- save ------------------------------------------------------------------
    def save(self, step: int, state: Any, *, mesh=None, specs: Any = None) -> str:
        """Save `state` as step `step`.  On a mesh every rank calls it with
        its blocks and the state's spec tree (`specs`); see the module."""
        if mesh is not None:
            return self._save_meshed(step, state, mesh, specs)
        self.wait()
        t0 = time.perf_counter()
        host = [(name, _host_copy(v)) for name, v in flatten_state(state)]
        stats = {"step": step, "bytes": sum(a.nbytes for _, a in host),
                 "snapshot_s": time.perf_counter() - t0, "write_s": None}
        self.last_save = stats
        final = self.step_dir(step)

        def write():
            t1 = time.perf_counter()
            tmp, manifest = self._begin(final, step)
            while host:
                name, arr = host.pop(0)  # each leaf's host copy goes once written
                self._write_leaf(tmp, manifest, name, arr)
                del arr
            self._commit(tmp, final, manifest)
            stats["write_s"] = time.perf_counter() - t1

        if self.async_save:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        else:
            write()
        return final

    def _save_meshed(self, step: int, state: Any, mesh, specs: Any) -> str:
        if specs is None:
            raise ValueError("a meshed save needs the state's specs")
        by_path = _spec_of(specs)
        final = self.step_dir(step)
        root = mesh.rank == 0
        t0 = time.perf_counter()
        if root:
            tmp, manifest = self._begin(final, step)
        nbytes, gather_s = 0, 0.0
        for name, t in flatten_state(state):
            if name not in by_path:
                raise KeyError(f"the specs have no leaf {name!r}")
            t1 = time.perf_counter()
            arr = gather_leaf(t, mesh, by_path[name])
            gather_s += time.perf_counter() - t1
            if root:
                nbytes += arr.nbytes
                self._write_leaf(tmp, manifest, name, arr)
                del arr
        if root:
            self._commit(tmp, final, manifest)
            self.last_save = {"step": step, "bytes": nbytes, "snapshot_s": gather_s,
                              "write_s": time.perf_counter() - t0 - gather_s}
        dist.barrier()  # every rank sees the commit once save returns
        return final

    def _begin(self, final: str, step: int):
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        return tmp, {"step": step, "leaves": []}

    @staticmethod
    def _write_leaf(tmp: str, manifest: dict, name: str, arr: np.ndarray) -> None:
        fn = name.replace("/", "__") + ".npy"
        np.save(os.path.join(tmp, fn), arr)
        manifest["leaves"].append(
            {"path": name, "file": fn, "shape": list(arr.shape), "dtype": str(arr.dtype)}
        )

    def _commit(self, tmp: str, final: str, manifest: dict) -> None:
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # commit point
        self._gc_old()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # -- restore -------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        steps = []
        for d in os.listdir(self.root):
            m = _STEP_RE.match(d)
            if m and os.path.exists(os.path.join(self.root, d, "MANIFEST.json")):
                steps.append(int(m.group(1)))
        return max(steps) if steps else None

    def step_dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:09d}")

    def open_leaves(self, step: int, target: Any, *, mesh=None,
                    specs: Any = None) -> Iterator[Tuple[str, np.ndarray, torch.Tensor]]:
        """``(path, memory-mapped array, target tensor)`` for every leaf of
        `target`, checked against the manifest's shape and dtype.  On a mesh
        the array is the view of this rank's block under `specs`."""
        d = self.step_dir(step)
        with open(os.path.join(d, "MANIFEST.json")) as f:
            by_path = {leaf["path"]: leaf for leaf in json.load(f)["leaves"]}
        spec_by_path = _spec_of(specs) if mesh is not None else {}
        for name, dst in flatten_state(target):
            meta = by_path.get(name)
            if meta is None:
                raise KeyError(f"checkpoint step {step} has no leaf {name!r}")
            arr = np.load(os.path.join(d, meta["file"]), mmap_mode="r")
            if mesh is not None:
                if name not in spec_by_path:
                    raise KeyError(f"the specs have no leaf {name!r}")
                arr = arr[block_index(arr.shape, mesh, spec_by_path[name])]
            want = (tuple(dst.shape), str(dst.dtype).replace("torch.", ""))
            if (tuple(arr.shape), str(arr.dtype)) != want:
                raise ValueError(
                    f"checkpoint leaf {name!r} is {arr.dtype}{list(arr.shape)}, the target "
                    f"{want[1]}{list(want[0])}")
            yield name, arr, dst

    @torch.no_grad()
    def restore(self, step: Optional[int] = None, *, target: Any, mesh=None,
                specs: Any = None) -> Any:
        """Load a checkpoint INTO `target` (a state of the same structure):
        every leaf is copied into the target's own tensor, chunk by chunk,
        and the target is returned.  On a mesh, `target` holds this rank's
        blocks under `specs`, and only they are read."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoint under {self.root}")
        for _name, arr, dst in self.open_leaves(step, target, mesh=mesh, specs=specs):
            for src, out in leaf_chunks(arr, dst):
                out.copy_(torch.from_numpy(np.array(src)))
        return target

    # -- gc ------------------------------------------------------------------------
    def _gc_old(self) -> None:
        steps = sorted(
            int(_STEP_RE.match(d).group(1))
            for d in os.listdir(self.root)
            if _STEP_RE.match(d)
        )
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.root, f"step_{s:09d}"), ignore_errors=True)

    def _gc_tmp(self) -> None:
        for d in os.listdir(self.root):
            if d.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.root, d), ignore_errors=True)
