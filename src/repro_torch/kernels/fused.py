"""Python bindings of the fused CUDA kernels in ``csrc/fused.cu``.

One binding per kernel.  Each checks device, dtype, shape, contiguity and
alignment, allocates its output with ``torch.empty``, launches on the
current stream of the tensor's device without synchronising, raises if the
launch was refused, and adds one to its entry of ``LAUNCHES``.  They take
CUDA tensors only: a tensor anywhere else raises.  Their plain versions, with
the same arguments, are ``kernels.ref.fused_dense`` / ``fused_sparse`` /
``fused_gen``.

Encoded words and the (F, 2) [seed, max] params are int32 tensors carrying
uint32 bit patterns.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# launches of each kernel since the last ``reset_launches`` (the main path's
# proof that it ran through the kernels)
LAUNCHES = {"fused_dense": 0, "fused_sparse": 0, "fused_gen": 0}

# dynamic shared memory one block may use on Hopper (227 KB)
MAX_SHARED_BYTES = 232_448

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIGNATURES = {
    "presto_fused_dense": (_P, _P, _I64, _P),
    "presto_fused_sparse": (_P, _P, _P, _I64, _I64, _I32, _P),
    "presto_fused_gen": (_P, _P, _P, _P, _I64, _I64, _I32, _P),
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(
    t: torch.Tensor, name: str, dtype: torch.dtype, shape, device=None, align: int = 4
) -> None:
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        where = t.device if isinstance(t, torch.Tensor) else type(t).__name__
        raise ValueError(f"{name} must be a CUDA tensor, got {where}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, the words on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(
        want is not None and got != want for got, want in zip(t.shape, shape)
    ):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned")


def _launch(entry: str, device: torch.device, *args) -> None:
    lib = _build.load("fused", _SIGNATURES)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, entry)(*args, stream)
    if err != 0:
        msg = lib.presto_error_string(err).decode()
        raise RuntimeError(f"{entry}: CUDA error {err} ({msg})")


def fused_dense(words: torch.Tensor) -> torch.Tensor:
    """(F, G, 4) int32 plane words -> (F, G, 4) f32 log1p(max(x, 0))."""
    _check(words, "words", torch.int32, (None, None, 4), align=16)
    out = torch.empty(words.shape, dtype=torch.float32, device=words.device)
    n = words.shape[0] * words.shape[1]
    if n:
        _launch("presto_fused_dense", words.device, words.data_ptr(), out.data_ptr(), n)
        LAUNCHES["fused_dense"] += 1
    return out


def fused_sparse(words: torch.Tensor, params: torch.Tensor, *, width: int) -> torch.Tensor:
    """(F, G, width) int32 bit-packed words + (F, 2) int32 [seed, max]
    -> (F, G, 32) int32 hashed ids."""
    if not 1 <= width <= 32:
        raise ValueError(f"width={width} outside [1, 32]")
    _check(words, "words", torch.int32, (None, None, width))
    f, g, _ = words.shape
    _check(params, "params", torch.int32, (f, 2), words.device)
    out = torch.empty((f, g, 32), dtype=torch.int32, device=words.device)
    if f * g:
        _launch(
            "presto_fused_sparse", words.device,
            words.data_ptr(), params.data_ptr(), out.data_ptr(), f, g, width,
        )
        LAUNCHES["fused_sparse"] += 1
    return out


def fused_gen(
    words: torch.Tensor, boundaries: torch.Tensor, params: torch.Tensor
) -> torch.Tensor:
    """(F, G, 4) int32 plane words + (F, m) f32 sorted, NaN-free boundaries
    + (F, 2) int32 [seed, max] -> (F, G, 4) int32 hashed bucket ids."""
    _check(words, "words", torch.int32, (None, None, 4), align=16)
    f, g, _ = words.shape
    _check(boundaries, "boundaries", torch.float32, (f, None), words.device)
    _check(params, "params", torch.int32, (f, 2), words.device)
    m = boundaries.shape[1]
    if m * 4 > MAX_SHARED_BYTES:
        raise ValueError(
            f"{m} boundaries need {m * 4} bytes of shared memory, "
            f"more than the {MAX_SHARED_BYTES} a block may use"
        )
    if f > 65535:
        raise ValueError(f"{f} features exceed the grid's y limit of 65535")
    out = torch.empty((f, g, 4), dtype=torch.int32, device=words.device)
    if f * g:
        _launch(
            "presto_fused_gen", words.device,
            words.data_ptr(), boundaries.data_ptr(), params.data_ptr(),
            out.data_ptr(), f, g, m,
        )
        LAUNCHES["fused_gen"] += 1
    return out
