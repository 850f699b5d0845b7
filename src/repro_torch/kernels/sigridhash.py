"""Python binding of the standalone SigridHash kernel in
``csrc/sigridhash.cu``.

The counterpart of ``repro.kernels.sigridhash``.  The binding works as
``kernels._binding`` describes: checked arguments, an output from
``torch.empty``, a launch on the current stream that raises if refused, and
one more in ``LAUNCHES``.  Its plain version, with the same arguments, is
``kernels.ref.sigridhash_params``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._binding import I64, P, check, check_grid_y, count, launch

_SIGNATURES = {"presto_sigridhash": (P, P, P, I64, I64, P)}


def sigridhash(values: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """(F, N) int32 values + (F, 2) int32 [seed, max] (uint32 bits)
    -> (F, N) int32 hashed ids in [0, max)."""
    check(values, "values", torch.int32, (None, None))
    f, n = values.shape
    check(params, "params", torch.int32, (f, 2), values.device)
    check_grid_y(f)
    out = torch.empty((f, n), dtype=torch.int32, device=values.device)
    if f * n:
        launch("sigridhash", _SIGNATURES, "presto_sigridhash", values.device,
               values.data_ptr(), params.data_ptr(), out.data_ptr(), f, n)
        count("sigridhash")
    return out
