"""Small shared utilities of the port: the device an entry point runs on,
the card's line, timing, tree accounting and formatting (the port of
``repro.common.util``).  A tree is a nested dict, list or tuple of tensors,
numpy arrays or ``ShapeDtype`` records, or an ``nn.Module``."""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Any, Iterator, List, NamedTuple

import numpy as np
import torch
from torch import nn


def resolve_device(device: torch.device | str | None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Raises when CUDA is asked for (or defaulted to) and absent —
    the port never falls back to the CPU on its own."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch path"
        )
    return device


def card_line(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them (the device's name
    alone where nvidia-smi cannot be run), or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={device.index or 0}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], check=True, capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(device)


class ShapeDtype(NamedTuple):
    """A tensor's shape and dtype with no storage: the port's stand-in for
    the reference's ``jax.ShapeDtypeStruct`` in ``launch.specs`` and
    ``core.preprocess``."""

    shape: tuple
    dtype: torch.dtype


class Timer:
    """Wall-clock timer usable as context manager or start/stop pairs."""

    def __init__(self) -> None:
        self.elapsed = 0.0
        self._start: float | None = None

    def __enter__(self) -> "Timer":
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc: Any) -> None:
        assert self._start is not None
        self.elapsed += time.perf_counter() - self._start
        self._start = None


@contextmanager
def timed(label: str, sink: dict | None = None) -> Iterator[None]:
    """Add the block's wall seconds to ``sink[label]``."""
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    if sink is not None:
        sink[label] = sink.get(label, 0.0) + dt


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of a nested dict, list or tuple, in order; an
    ``nn.Module``'s leaves are its parameters and buffers."""
    if isinstance(tree, nn.Module):
        return [*tree.parameters(), *tree.buffers()]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)) and not isinstance(tree, ShapeDtype):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def _numel(leaf: Any) -> int:
    return int(np.prod(tuple(leaf.shape), dtype=np.int64))


def _itemsize(dtype: Any) -> int:
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return np.dtype(dtype).itemsize


def bytes_of_tree(tree: Any) -> int:
    """Total bytes across all tensor, array and ``ShapeDtype`` leaves of a
    tree (meta tensors count their shape's bytes)."""
    total = 0
    for leaf in tree_leaves(tree):
        if hasattr(leaf, "shape") and hasattr(leaf, "dtype"):
            total += _numel(leaf) * _itemsize(leaf.dtype)
    return total


def param_count(tree: Any) -> int:
    """Total elements across all leaves with a shape."""
    return sum(_numel(leaf) for leaf in tree_leaves(tree) if hasattr(leaf, "shape"))


def human_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB", "PiB"):
        if abs(n) < 1024.0:
            return f"{n:.2f} {unit}"
        n /= 1024.0
    return f"{n:.2f} EiB"


def human_flops(n: float) -> str:
    for unit in ("FLOP", "KFLOP", "MFLOP", "GFLOP", "TFLOP", "PFLOP"):
        if abs(n) < 1000.0:
            return f"{n:.2f} {unit}"
        n /= 1000.0
    return f"{n:.2f} EFLOP"
