"""Python bindings of the standalone decode kernels in ``csrc/decode.cu``.

The counterpart of ``repro.kernels.decode``.  Each binding works as
``kernels._binding`` describes: checked arguments, an output from
``torch.empty``, a launch on the current stream that raises if refused, and
one more in ``LAUNCHES``.  Their plain versions, with the same arguments,
are ``kernels.ref.bitunpack_grouped`` and ``bytesplit_decode_grouped``.
``bitunpack_lengths`` is ``bitunpack`` for the per-row lengths, counted
apart, so a path's launches tell the two decodes apart.

Encoded words are int32 tensors carrying uint32 bit patterns.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._binding import I32, I64, P, check, check_grid_y, count, launch

_SIGNATURES = {
    "presto_bitunpack": (P, P, I64, I64, I32, P),
    "presto_bytesplit": (P, P, I64, P),
}


def bitunpack(words: torch.Tensor, *, width: int) -> torch.Tensor:
    """(F, G, width) int32 bit-packed words -> (F, G, 32) int32 values."""
    return _bitunpack(words, width, "bitunpack")


def bitunpack_lengths(words: torch.Tensor, *, width: int) -> torch.Tensor:
    """``bitunpack`` of the lengths pages, counted as "bitunpack.lengths"."""
    return _bitunpack(words, width, "bitunpack.lengths")


def _bitunpack(words: torch.Tensor, width: int, counter: str) -> torch.Tensor:
    if not 1 <= width <= 32:
        raise ValueError(f"width={width} outside [1, 32]")
    check(words, "words", torch.int32, (None, None, width))
    f, g, _ = words.shape
    check_grid_y(f)
    out = torch.empty((f, g, 32), dtype=torch.int32, device=words.device)
    if f * g:
        launch("decode", _SIGNATURES, "presto_bitunpack", words.device,
               words.data_ptr(), out.data_ptr(), f, g, width)
        count(counter)
    return out


def bytesplit(words: torch.Tensor) -> torch.Tensor:
    """(F, G, 4) int32 plane words -> (F, G, 4) f32 values, bit-exact.

    Words need only 4-byte alignment: a view that is not 16-byte aligned
    takes the kernel's 4-byte loads."""
    check(words, "words", torch.int32, (None, None, 4))
    out = torch.empty(words.shape, dtype=torch.float32, device=words.device)
    n = words.shape[0] * words.shape[1]
    if n:
        launch("decode", _SIGNATURES, "presto_bytesplit", words.device,
               words.data_ptr(), out.data_ptr(), n)
        count("bytesplit")
    return out
