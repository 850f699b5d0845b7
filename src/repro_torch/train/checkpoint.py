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
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

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


def leaf_chunks(arr: np.ndarray, dst: torch.Tensor) -> Iterator[Tuple[np.ndarray, torch.Tensor]]:
    """Matching chunks of a (memory-mapped) array and a contiguous tensor of
    its shape, both flattened, each of at most ``CHUNK_BYTES``."""
    flat, out = arr.reshape(-1), dst.view(-1)
    step = max(1, CHUNK_BYTES // arr.itemsize)
    for start in range(0, flat.shape[0], step):
        yield flat[start:start + step], out[start:start + step]


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
        self._gc_tmp()

    # -- save ------------------------------------------------------------------
    def save(self, step: int, state: Any) -> str:
        self.wait()
        t0 = time.perf_counter()
        host = [(name, _host_copy(v)) for name, v in flatten_state(state)]
        stats = {"step": step, "bytes": sum(a.nbytes for _, a in host),
                 "snapshot_s": time.perf_counter() - t0, "write_s": None}
        self.last_save = stats
        final = self.step_dir(step)

        def write():
            t1 = time.perf_counter()
            tmp = final + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            manifest = {"step": step, "leaves": []}
            while host:
                name, arr = host.pop(0)  # each leaf's host copy goes once written
                fn = name.replace("/", "__") + ".npy"
                np.save(os.path.join(tmp, fn), arr)
                manifest["leaves"].append(
                    {"path": name, "file": fn, "shape": list(arr.shape),
                     "dtype": str(arr.dtype)}
                )
                del arr
            with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)  # commit point
            self._gc_old()
            stats["write_s"] = time.perf_counter() - t1

        if self.async_save:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        else:
            write()
        return final

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

    def open_leaves(self, step: int, target: Any) -> Iterator[Tuple[str, np.ndarray, torch.Tensor]]:
        """``(path, memory-mapped array, target tensor)`` for every leaf of
        `target`, checked against the manifest's shape and dtype."""
        d = self.step_dir(step)
        with open(os.path.join(d, "MANIFEST.json")) as f:
            by_path = {leaf["path"]: leaf for leaf in json.load(f)["leaves"]}
        for name, dst in flatten_state(target):
            meta = by_path.get(name)
            if meta is None:
                raise KeyError(f"checkpoint step {step} has no leaf {name!r}")
            arr = np.load(os.path.join(d, meta["file"]), mmap_mode="r")
            want = (tuple(dst.shape), str(dst.dtype).replace("torch.", ""))
            if (tuple(arr.shape), str(arr.dtype)) != want:
                raise ValueError(
                    f"checkpoint leaf {name!r} is {arr.dtype}{list(arr.shape)}, the target "
                    f"{want[1]}{list(want[0])}")
            yield name, arr, dst

    @torch.no_grad()
    def restore(self, step: Optional[int] = None, *, target: Any) -> Any:
        """Load a checkpoint INTO `target` (a state of the same structure):
        every leaf is copied into the target's own tensor, chunk by chunk,
        and the target is returned."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoint under {self.root}")
        for _name, arr, dst in self.open_leaves(step, target):
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
