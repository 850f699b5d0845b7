"""Python binding of the standalone Log kernel in ``csrc/lognorm.cu``.

The counterpart of ``repro.kernels.lognorm``.  The binding works as
``kernels._binding`` describes: checked arguments, an output from
``torch.empty``, a launch on the current stream that raises if refused, and
one more in ``LAUNCHES``.  Its plain version, with the same arguments, is
``kernels.ref.lognorm``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._binding import I64, P, check, count, launch

_SIGNATURES = {"presto_lognorm": (P, P, I64, P)}


def lognorm(x: torch.Tensor) -> torch.Tensor:
    """f32 tensor of any shape -> log1p(max(x, 0)) of the same shape, NaN
    kept.  Needs only 4-byte alignment: a view that is not 16-byte aligned
    takes the kernel's 4-byte accesses."""
    check(x, "x", torch.float32, None)
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    if x.numel():
        launch("lognorm", _SIGNATURES, "presto_lognorm", x.device,
               x.data_ptr(), out.data_ptr(), x.numel())
        count("lognorm")
    return out
