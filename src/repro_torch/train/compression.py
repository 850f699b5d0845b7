"""Gradient compression for the cross-pod reduction.

The port of ``repro.train.compression``.  Within a pod gradients are
averaged in full precision; across pods each rank all-gathers int8
gradients and one f32 scale per tensor, and carries what quantization lost
into the next step (error feedback: Seide et al., Karimireddy et al.).

int8 quantization: per-tensor symmetric scale = max|g| / 127 + 1e-12,
q = clip(round(g / scale), -127, 127) with round half to even (as
``jnp.round``), and the residual g - q * scale.  A tensor sharded within
the pod takes its max over its blocks (``comm.pmax``), so every block is
quantized as the whole tensor would be.  The pod hop then carries numel
bytes plus a 4-byte scale per tensor, against 4 * numel for an f32
all-reduce (``mesh.counter``'s ``all-gather`` bytes).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.distributed import comm
from repro_torch.distributed.sharding import spec_axes

Tensors = Dict[str, torch.Tensor]


def quantize_int8(
    g: torch.Tensor, amax: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """g -> (q int8, scale f32 scalar, residual f32).  `amax` is max|g| of
    the whole tensor where `g` is one block of it (default: of `g`)."""
    g32 = g.to(torch.float32)
    if amax is None:
        amax = torch.max(torch.abs(g32))
    scale = amax / 127.0 + 1e-12
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    residual = g32 - q.to(torch.float32) * scale
    return q, scale, residual


def init_error_state(params: Tensors) -> Tensors:
    """Zero error feedback, one f32 tensor per parameter."""
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def crosspod_compressed_mean(
    grads: Tensors, err: Tensors, mesh, axis: str = "pod",
    specs: Optional[Dict[str, tuple]] = None,
) -> Tuple[Tensors, Tensors]:
    """Compressed mean of the pods' gradients over `axis`.

    `grads` are this rank's blocks of its pod's mean gradients, `specs`
    their specs within the pod (default: replicated).  Returns (the
    global mean's blocks, new error state)."""
    npods = mesh.shape[axis]
    out, new_err = {}, {}
    for name, g in grads.items():
        x = g.to(torch.float32) + err[name]
        amax = torch.max(torch.abs(x))
        for a in spec_axes(specs[name]) if specs else ():
            amax = comm.pmax(amax, mesh, a)
        q, scale, residual = quantize_int8(x, amax)
        q_all = comm.all_gather(q, mesh, axis)  # (npods, ...) int8 over the pod hop
        s_all = comm.all_gather(scale, mesh, axis)  # (npods,)
        deq = q_all.to(torch.float32) * s_all.reshape((npods,) + (1,) * g.dim())
        out[name] = deq.mean(dim=0).to(g.dtype)
        new_err[name] = residual
    return out, new_err
