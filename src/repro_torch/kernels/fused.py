"""Python bindings of the fused CUDA kernels in ``csrc/fused.cu``.

One binding per kernel, each working as ``kernels._binding`` describes:
checked arguments, an output from ``torch.empty``, a launch on the current
stream that raises if refused, and one more in ``LAUNCHES``.  Their plain
versions, with the same arguments, are ``kernels.ref.fused_dense`` /
``fused_sparse`` / ``fused_gen``.

Encoded words and the (F, 2) [seed, max] params are int32 tensors carrying
uint32 bit patterns.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._binding import (
    I32,
    I64,
    LAUNCHES,
    P,
    bucket_staged,
    check,
    check_grid_y,
    count,
    launch,
    reset_launches,
)

_SIGNATURES = {
    "presto_fused_dense": (P, P, I64, P),
    "presto_fused_sparse": (P, P, P, I64, I64, I32, P),
    "presto_fused_gen": (P, P, P, P, I64, I64, I32, I32, P),
}

# the shared counter and its reset, also reachable from here
__all__ = ["LAUNCHES", "fused_dense", "fused_gen", "fused_sparse", "reset_launches"]


def fused_dense(words: torch.Tensor) -> torch.Tensor:
    """(F, G, 4) int32 plane words -> (F, G, 4) f32 log1p(max(x, 0))."""
    check(words, "words", torch.int32, (None, None, 4), align=16)
    out = torch.empty(words.shape, dtype=torch.float32, device=words.device)
    n = words.shape[0] * words.shape[1]
    if n:
        launch("fused", _SIGNATURES, "presto_fused_dense", words.device,
               words.data_ptr(), out.data_ptr(), n)
        count("fused_dense")
    return out


def fused_sparse(words: torch.Tensor, params: torch.Tensor, *, width: int) -> torch.Tensor:
    """(F, G, width) int32 bit-packed words + (F, 2) int32 [seed, max]
    -> (F, G, 32) int32 hashed ids."""
    if not 1 <= width <= 32:
        raise ValueError(f"width={width} outside [1, 32]")
    check(words, "words", torch.int32, (None, None, width))
    f, g, _ = words.shape
    check(params, "params", torch.int32, (f, 2), words.device)
    check_grid_y(f)
    out = torch.empty((f, g, 32), dtype=torch.int32, device=words.device)
    if f * g:
        launch(
            "fused", _SIGNATURES, "presto_fused_sparse", words.device,
            words.data_ptr(), params.data_ptr(), out.data_ptr(), f, g, width,
        )
        count("fused_sparse")
    return out


def fused_gen(
    words: torch.Tensor, boundaries: torch.Tensor, params: torch.Tensor
) -> torch.Tensor:
    """(F, G, 4) int32 plane words + (F, m) f32 sorted, NaN-free boundaries
    + (F, 2) int32 [seed, max] -> (F, G, 4) int32 hashed bucket ids."""
    check(words, "words", torch.int32, (None, None, 4), align=16)
    f, g, _ = words.shape
    check(boundaries, "boundaries", torch.float32, (f, None), words.device)
    check(params, "params", torch.int32, (f, 2), words.device)
    m = boundaries.shape[1]
    staged = bucket_staged(m)
    check_grid_y(f)
    out = torch.empty((f, g, 4), dtype=torch.int32, device=words.device)
    if f * g:
        launch(
            "fused", _SIGNATURES, "presto_fused_gen", words.device,
            words.data_ptr(), boundaries.data_ptr(), params.data_ptr(),
            out.data_ptr(), f, g, m, int(staged),
        )
        count("fused_gen")
    return out
