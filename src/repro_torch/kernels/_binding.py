"""What every kernel binding shares: argument checks, the launch through
ctypes, and the launch counters.

A binding checks device, dtype, shape, contiguity and alignment
(``check``), allocates its output with ``torch.empty``, launches on the
current stream of the tensor's device without synchronising (``launch``),
raises if the launch was refused, and adds one to its entry of ``LAUNCHES``
(``count``, under a lock: loader threads launch concurrently).
Bindings take CUDA tensors only: a tensor anywhere else raises.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Mapping, Sequence

import torch

from repro_torch.kernels import _build

# launches of each kernel since the last ``reset_launches`` (a run's proof
# that its path went through the kernels); one dict for all of them.  The
# lengths decode runs the bitunpack kernel through its own entry point
# (``decode.bitunpack_lengths``) and is counted apart as "bitunpack.lengths".
LAUNCHES = {
    "fused_dense": 0,
    "fused_sparse": 0,
    "fused_gen": 0,
    "bitunpack": 0,
    "bitunpack.lengths": 0,
    "bytesplit": 0,
    "sigridhash": 0,
    "bucketize": 0,
    "lognorm": 0,
}

# dynamic shared memory one block may use on Hopper (227 KB)
MAX_SHARED_BYTES = 232_448

P, I64, I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


_LAUNCHES_LOCK = threading.Lock()


def count(name: str) -> None:
    """Add one launch of kernel `name`; safe across threads."""
    with _LAUNCHES_LOCK:
        LAUNCHES[name] += 1


def reset_launches() -> None:
    with _LAUNCHES_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def check(
    t: torch.Tensor, name: str, dtype: torch.dtype, shape, device=None, align: int = 4
) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` and `shape`
    (None matches any extent), on `device` if given, aligned to `align`."""
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        where = t.device if isinstance(t, torch.Tensor) else type(t).__name__
        raise ValueError(f"{name} must be a CUDA tensor, got {where}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, the words on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and (t.dim() != len(shape) or any(
        want is not None and got != want for got, want in zip(t.shape, shape)
    )):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned")


def check_grid_y(f: int) -> None:
    """Kernels with the feature on blockIdx.y take at most 65535 features."""
    if f > 65535:
        raise ValueError(f"{f} features exceed the grid's y limit of 65535")


def bucket_staged(m: int) -> bool:
    """The mode of the bucket kernels for m boundaries: True where the tree
    of m rounded up to a power of two f32 slots (``bucket_smem`` in
    ``csrc/common.cuh``) fits in a block's shared memory (m <= 32768), else
    False, and the kernels search the sorted boundaries in device memory.
    Only an m the kernels' int cannot hold is refused."""
    if not 0 <= m < 2**31:
        raise ValueError(f"{m} boundaries: the bucket kernels take 0 <= m < 2**31")
    return (4 << (m - 1).bit_length() if m > 0 else 0) <= MAX_SHARED_BYTES


def launch(
    library: str,
    signatures: Mapping[str, Sequence],
    entry: str,
    device: torch.device,
    *args,
) -> None:
    """Call C entry `entry` of ``csrc/<library>.cu`` with `args` and the
    current stream of `device`; raise on a nonzero ``cudaError_t``."""
    lib = _build.load(library, signatures)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, entry)(*args, stream)
    if err != 0:
        msg = lib.presto_error_string(err).decode()
        raise RuntimeError(f"{entry}: CUDA error {err} ({msg})")
