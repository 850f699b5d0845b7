"""Plain PyTorch versions of the preprocessing kernels.

The twin of ``repro.kernels.ref``, plus the functions the CUDA kernels in
``csrc/`` compute, with the same arguments as their bindings: the fused
chains (``kernels.fused``), and the standalone passes ``bitunpack_grouped``
and ``bytesplit_decode_grouped`` (``kernels.decode``),
``sigridhash_params`` (``kernels.sigridhash``), ``bucketize``
(``kernels.bucketize``) and ``lognorm`` (``kernels.lognorm``).  The CPU
path runs these; ``chip_smoke.py`` holds every kernel against them on the
card.  They run on any device.

Encoded words are ``int32`` tensors carrying uint32 bit patterns.  PyTorch
has no uint32 ``>>``, ``<<``, ``+`` or ``%`` on the CPU, so the arithmetic
runs in int64 on values masked to 32 bits.  A product of two full 32-bit
values would overflow int64, so every multiply by a 32-bit constant is split
into its 16-bit halves (``_mul32``).
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B1
_C1 = 0xCC9E2D51
_C2 = 0x85EBCA6B
_C3 = 0xC2B2AE35


def _u32(x):
    """int tensor or Python int -> its uint32 value (int64 tensor or int)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _M32
    return int(x) & _M32


def _mul32(a, c: int):
    """(a * c) mod 2**32 for uint32 values a (int64) and a constant c."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _M32


# -- SigridHash (Alg. 2) ------------------------------------------------------


def fmix32(h):
    """murmur3 finalizer over uint32 values held in int64."""
    h = h ^ (h >> 16)
    h = _mul32(h, _C2)
    h = h ^ (h >> 13)
    h = _mul32(h, _C3)
    h = h ^ (h >> 16)
    return h


def sigridhash(values: torch.Tensor, seed, max_value) -> torch.Tensor:
    """values int -> int32 indices in [0, max_value).

    ``seed`` and ``max_value`` are Python ints or int tensors that broadcast
    against ``values`` (one pair per feature)."""
    v = _u32(values)
    s = _u32(seed)
    h = (_mul32(v ^ _mul32(s, _GOLDEN), _C1) + s) & _M32
    return (fmix32(h) % _u32(max_value)).to(torch.int32)


def sigridhash_params(values: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """(F, N) values + (F, 2) [seed, max] -> (F, N) int32: the arguments of
    the standalone kernel (``kernels.sigridhash.sigridhash``)."""
    return sigridhash(values, params[:, :1], params[:, 1:])


# -- Bucketize (Alg. 1) -------------------------------------------------------


def flush_denormals(x: torch.Tensor) -> torch.Tensor:
    """Subnormal floats -> 0, as the reference's XLA comparisons see them
    (XLA on the CPU, like the TPU, treats subnormal inputs as zero)."""
    return torch.where(x.abs() < torch.finfo(x.dtype).tiny, torch.zeros_like(x), x)


def bucketize(values: torch.Tensor, boundaries: torch.Tensor) -> torch.Tensor:
    """Compare-and-count: c[..., i] = #{j : boundaries[..., j] <= values[..., i]}.

    values (..., n) f32, boundaries (..., m) f32 broadcasting against the
    leading axes -> (..., n) int32.  NaN counts nothing; +inf counts every
    boundary, +inf padding included; subnormals compare as zero."""
    hits = flush_denormals(values).unsqueeze(-1) >= flush_denormals(boundaries).unsqueeze(-2)
    return hits.sum(dim=-1, dtype=torch.int32)


# -- Log normalization ---------------------------------------------------------


def lognorm(x: torch.Tensor) -> torch.Tensor:
    """log1p(max(x, 0)) with NaN kept, as ``jnp.maximum`` keeps it."""
    return torch.log1p(torch.where(x < 0, torch.zeros_like(x), x))


# -- Decode: bitpack -----------------------------------------------------------


def bitunpack_grouped(words: torch.Tensor, width: int) -> torch.Tensor:
    """Grouped layout: (..., G, w) words -> (..., G, 32) int32 values.

    Group g holds values [32g, 32(g+1)) in words [g*w, (g+1)*w), LSB-first.
    Value j reads word ``j*w >> 5`` and, only when it straddles a word edge,
    the next one — so no read leaves the group."""
    w = width
    p = _u32(words)
    j = torch.arange(32, device=words.device)
    bit = j * w
    wid, off = bit >> 5, bit & 31
    straddle = (off != 0) & (off + w > 32)
    lo = p[..., wid] >> off
    nxt = p[..., torch.where(straddle, wid + 1, wid)]
    hi = torch.where(straddle, (nxt << torch.where(straddle, 32 - off, 0)) & _M32, 0)
    mask = _M32 if w == 32 else (1 << w) - 1
    return ((lo | hi) & mask).to(torch.int32)


# -- Decode: byte-stream-split ---------------------------------------------------


def bytesplit_decode_grouped(plane_words: torch.Tensor) -> torch.Tensor:
    """(..., G, 4) plane words -> (..., G, 4) f32 values.

    plane_words[..., g, k] = word g of byte-plane k; value i = g*4 + j takes
    byte j from each plane word g."""
    p = _u32(plane_words)
    shifts = torch.arange(4, device=plane_words.device) * 8
    # bytes[..., g, j, k] = byte j of plane word k
    bytes_ = (p.unsqueeze(-2) >> shifts.unsqueeze(-1)) & 0xFF
    words = (bytes_ << shifts).sum(dim=-1)
    return words.to(torch.int32).view(torch.float32)


# -- Fused ISP paths (the plain versions of csrc/fused.cu) ----------------------


def fused_dense(plane_words: torch.Tensor) -> torch.Tensor:
    """(F, G, 4) words -> (F, G, 4) f32: byte-split decode, then Log."""
    return lognorm(bytesplit_decode_grouped(plane_words))


def fused_sparse(words: torch.Tensor, params: torch.Tensor, *, width: int) -> torch.Tensor:
    """(F, G, w) words + (F, 2) [seed, max] -> (F, G, 32) int32 hashed ids."""
    ids = bitunpack_grouped(words, width)
    return sigridhash(ids, params[:, 0, None, None], params[:, 1, None, None])


def fused_gen(
    plane_words: torch.Tensor, boundaries: torch.Tensor, params: torch.Tensor
) -> torch.Tensor:
    """(F, G, 4) words + (F, m) sorted boundaries + (F, 2) [seed, max]
    -> (F, G, 4) int32: byte-split decode, Bucketize, SigridHash."""
    f, g, four = plane_words.shape
    x = bytesplit_decode_grouped(plane_words).reshape(f, g * four)
    counts = bucketize(x, boundaries).reshape(f, g, four)
    return sigridhash(counts, params[:, 0, None, None], params[:, 1, None, None])
