"""Python binding of the standalone Bucketize kernel in ``csrc/bucketize.cu``.

The counterpart of ``repro.kernels.bucketize``.  The binding works as
``kernels._binding`` describes: checked arguments, an output from
``torch.empty``, a launch on the current stream that raises if refused, and
one more in ``LAUNCHES``.  Its plain version, with the same arguments, is
``kernels.ref.bucketize``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._binding import (
    I32,
    I64,
    P,
    bucket_staged,
    check,
    check_grid_y,
    count,
    launch,
)

_SIGNATURES = {"presto_bucketize": (P, P, P, I64, I64, I32, I32, P)}


def bucketize(values: torch.Tensor, boundaries: torch.Tensor) -> torch.Tensor:
    """(F, R) f32 values + (F, m) f32 sorted, NaN-free boundaries -> (F, R)
    int32 counts #{j : boundaries[f, j] <= values[f, r]}, subnormals as
    zero, NaN counting nothing."""
    check(values, "values", torch.float32, (None, None))
    f, r = values.shape
    check(boundaries, "boundaries", torch.float32, (f, None), values.device)
    m = boundaries.shape[1]
    staged = bucket_staged(m)
    check_grid_y(f)
    out = torch.empty((f, r), dtype=torch.int32, device=values.device)
    if f * r:
        launch("bucketize", _SIGNATURES, "presto_bucketize", values.device,
               values.data_ptr(), boundaries.data_ptr(), out.data_ptr(), f, r, m,
               int(staged))
        count("bucketize")
    return out
