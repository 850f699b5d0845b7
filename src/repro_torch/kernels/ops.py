"""Public wrappers around the preprocessing kernels.

The observable semantics of ``repro.kernels.ops``: boundaries are padded
with +inf to a multiple of 128 (so +inf counts the padding, as the reference
does), decodes come back as (F, G*4) or (F, G*32), and ``lognorm`` takes any
shape.  Where the JAX wrappers pad the row groups or values to a block
multiple, the CUDA kernels mask the tail, so any length works.

A CPU tensor goes to the plain version (``kernels.ref``); a CUDA tensor goes
to the CUDA kernel (``kernels.fused``, ``decode``, ``sigridhash``,
``bucketize``, ``lognorm``), which launches or raises.  Per-feature
seeds, table sizes and boundaries may be numpy arrays or tensors; the
lowering hands tensors already on the words' device, so the produce path
makes no host-to-device copy here.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.common.util import span
from repro_torch.kernels import bucketize as _bk
from repro_torch.kernels import decode as _dk
from repro_torch.kernels import fused, ref
from repro_torch.kernels import lognorm as _lk
from repro_torch.kernels import sigridhash as _sk

BOUNDARY_PAD = 128  # lane multiple the reference pads boundaries to


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def _backend(words: torch.Tensor):
    return ref if _on_cpu(words) else fused


def as_words(x) -> torch.Tensor:
    """uint32 words (numpy or tensor) -> the int32 tensor the kernels take."""
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.uint32).view(np.int32))
    if x.dtype == torch.uint32:
        return x.view(torch.int32)
    if x.dtype != torch.int32:
        raise TypeError(f"encoded words must be uint32 or int32, got {x.dtype}")
    return x


def u32_tensor(x, device: torch.device) -> torch.Tensor:
    """Per-feature uint32 parameters -> an int32 tensor of their bits."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int32) if x.dtype == torch.uint32 else x.to(torch.int32)
        return x.to(device)
    arr = np.asarray(x).astype(np.uint32).view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def hash_params(seeds, max_values, device: torch.device) -> torch.Tensor:
    """(F,) seeds and (F,) table sizes -> the (F, 2) [seed, max] params,
    stacked on `device` in the span ``ops.hash_params``."""
    with span("ops.hash_params"):
        return torch.stack(
            [u32_tensor(seeds, device), u32_tensor(max_values, device)], dim=1
        ).contiguous()


def pad_boundaries(boundaries, device: torch.device) -> torch.Tensor:
    """(F, m) boundaries -> f32 on `device`, +inf padded to a multiple of 128."""
    b = torch.as_tensor(boundaries, dtype=torch.float32).to(device)
    pad = (-b.shape[1]) % BOUNDARY_PAD
    if pad:
        b = torch.nn.functional.pad(b, (0, pad), value=float("inf"))
    return b.contiguous()


def fused_dense(plane_words) -> torch.Tensor:
    """ISP dense path: decode + Log in one kernel. (F, G, 4) -> (F, G*4) f32."""
    w = as_words(plane_words)
    f, g, _ = w.shape
    return _backend(w).fused_dense(w).reshape(f, g * 4)


def fused_gen(plane_words, boundaries, seeds, max_values) -> torch.Tensor:
    """ISP generation path: decode + Bucketize + SigridHash in one kernel.

    plane_words (F, G, 4) encoded dense sources, boundaries (F, m) sorted ->
    (F, G*4) int32 table indices."""
    w = as_words(plane_words)
    f, g, _ = w.shape
    b = pad_boundaries(boundaries, w.device)
    params = hash_params(seeds, max_values, w.device)
    return _backend(w).fused_gen(w, b, params).reshape(f, g * 4)


def fused_sparse(packed, seeds, max_values, *, width: int) -> torch.Tensor:
    """ISP sparse path: decode + SigridHash in one kernel.

    packed (F, G, w) words -> (F, G*32) int32 indices in [0, d)."""
    w = as_words(packed)
    f, g, _ = w.shape
    params = hash_params(seeds, max_values, w.device)
    return _backend(w).fused_sparse(w, params, width=width).reshape(f, g * 32)


def decode_bitpack(packed, *, width: int) -> torch.Tensor:
    """Grouped bitpack decode: (F, G, w) words -> (F, G*32) int32 values."""
    w = as_words(packed)
    f, g, _ = w.shape
    out = ref.bitunpack_grouped(w, width) if _on_cpu(w) else _dk.bitunpack(w, width=width)
    return out.reshape(f, g * 32)


def decode_lengths(packed, *, width: int) -> torch.Tensor:
    """``decode_bitpack`` of the per-row lengths, its launches counted apart."""
    w = as_words(packed)
    f, g, _ = w.shape
    out = ref.bitunpack_grouped(w, width) if _on_cpu(w) else _dk.bitunpack_lengths(w, width=width)
    return out.reshape(f, g * 32)


def decode_bytesplit(plane_words) -> torch.Tensor:
    """Grouped byte-split decode: (F, G, 4) words -> (F, G*4) f32 values."""
    w = as_words(plane_words)
    f, g, _ = w.shape
    out = ref.bytesplit_decode_grouped(w) if _on_cpu(w) else _dk.bytesplit(w)
    return out.reshape(f, g * 4)


def sigridhash(values, seeds, max_values) -> torch.Tensor:
    """Feature normalization (Alg. 2). values (F, N) int -> (F, N) int32 in
    [0, d)."""
    v = torch.as_tensor(values)
    v = (v if v.dtype == torch.int32 else v.to(torch.int32)).contiguous()
    params = hash_params(seeds, max_values, v.device)
    return ref.sigridhash_params(v, params) if _on_cpu(v) else _sk.sigridhash(v, params)


def bucketize(values, boundaries) -> torch.Tensor:
    """Feature generation (Alg. 1). values (F, R) f32, boundaries (F, m)
    sorted -> (F, R) int32 bucket ids in [0, m], +inf padding counted."""
    v = torch.as_tensor(values, dtype=torch.float32).contiguous()
    b = pad_boundaries(boundaries, v.device)
    return ref.bucketize(v, b) if _on_cpu(v) else _bk.bucketize(v, b)


def lognorm(x) -> torch.Tensor:
    """Dense normalization: log1p(max(x, 0)) elementwise, any shape."""
    x = torch.as_tensor(x, dtype=torch.float32).contiguous()
    return ref.lognorm(x) if _on_cpu(x) else _lk.lognorm(x)


# -- host-side layout helpers -------------------------------------------------


def regroup_bitpack(packed_flat: np.ndarray, n_values: int, width: int) -> np.ndarray:
    """Flat packed words (from data.encoding.bitpack) -> (G, w) grouped layout.

    Requires n_values % 32 == 0 (dataset partitions guarantee this)."""
    if n_values % 32:
        raise ValueError(f"n_values={n_values} is not a multiple of 32")
    g = n_values // 32
    return np.ascontiguousarray(packed_flat[: g * width].reshape(g, width))


def regroup_bytesplit(plane_words_flat: np.ndarray, n_values: int) -> np.ndarray:
    """Flat plane words (from bytesplit_encode) -> (G, 4) grouped layout."""
    if n_values % 4:
        raise ValueError(f"n_values={n_values} is not a multiple of 4")
    g = n_values // 4
    planes = plane_words_flat[: g * 4].reshape(4, g)
    return np.ascontiguousarray(planes.T)
