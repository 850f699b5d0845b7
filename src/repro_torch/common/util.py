"""Small shared utilities of the port: the device an entry point runs on,
the card's line, profiler spans, tree accounting and formatting (the port
of ``repro.common.util``).  A tree is a nested dict, list or tuple of
tensors, numpy arrays or ``ShapeDtype`` records, or an ``nn.Module``."""

from __future__ import annotations

import contextlib
from typing import Any, List, NamedTuple

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


_profiler_enabled = torch._C._autograd._profiler_enabled
_RecordFunctionFast = torch._C._profiler._RecordFunctionFast
NO_SPAN = contextlib.nullcontext()  # the one context of every span not recorded


def span(name: str):
    """A context that marks its block as the host range `name` in a
    ``torch.profiler`` trace, on the profiler's own clock: the device work
    launched inside it lies under the range (the launch and its kernel
    share ``args.correlation``).

    While the calling thread has no profiler running it returns
    ``NO_SPAN``, after one flag check (~0.4 us).  With one running, it
    returns a ``RecordFunction`` range, which is recorded (as a ``cpu_op``
    event) only where the profiler records host activity: a profiler of
    the device alone keeps no host range, and there the range costs ~1 us
    where ``torch.profiler.record_function`` costs ~14 us.  A thread the
    profiler was not enabled on (a pool worker) records nothing."""
    if _profiler_enabled():
        return _RecordFunctionFast(name)
    return NO_SPAN


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
