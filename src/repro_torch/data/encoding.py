"""Columnar page encodings (host-side encode, numpy decode oracles).

These are the wire encodings of the columnar store (our Parquet-lite), a
copy of ``repro.data.encoding`` that the PyTorch port keeps for itself. The
paper's ISP "Decode" unit consumes exactly these pages; the GPU decoders live
in ``repro_torch.kernels`` (CUDA) with plain PyTorch versions in
``repro_torch.kernels.ref`` that must match the numpy decoders here
bit-for-bit.

Encodings
---------
``bitpack(width)``
    n unsigned ints of bit-width ``w <= 32`` packed LSB-first into uint32
    words, padded with one trailing word so straddling reads never go out of
    bounds.  This is the workhorse for sparse-id values, dictionary codes and
    per-row lengths.

``dict`` (dictionary + bitpacked codes)
    Distinct values in a dictionary array; codes bitpacked at
    ``ceil(log2(len(dict)))`` bits.

``bytesplit`` (BYTE_STREAM_SPLIT)
    float32 values split into 4 byte planes (all byte-0s, then byte-1s, ...),
    which is what real columnar stores do before general-purpose compression.
    Decode reassembles the planes.

Widths are fixed at *dataset* level (not per page) so every partition of a
dataset decodes with one set of kernel launches at static shapes.  Real
systems use per-page frame-of-reference; we trade a few bits of entropy for
uniform ingestion, which is the right call on an accelerator.
"""

from __future__ import annotations

import numpy as np


def pack_words_needed(n: int, width: int) -> int:
    """Number of uint32 words to hold n values of `width` bits, +1 pad word."""
    if n == 0:
        return 1
    return (n * width + 31) // 32 + 1


def width_for(max_value: int) -> int:
    """Bit width needed to represent values in [0, max_value]."""
    if max_value <= 0:
        return 1
    return int(max_value).bit_length()


def bitpack(values: np.ndarray, width: int) -> np.ndarray:
    """Pack uint values (< 2**width) LSB-first into a uint32 word array."""
    values = np.asarray(values)
    assert width >= 1 and width <= 32, width
    v = values.astype(np.uint64) & ((np.uint64(1) << np.uint64(width)) - np.uint64(1))
    n = v.shape[0]
    out = np.zeros(pack_words_needed(n, width), dtype=np.uint64)
    bit_pos = np.arange(n, dtype=np.uint64) * np.uint64(width)
    word_idx = (bit_pos >> np.uint64(5)).astype(np.int64)
    bit_off = bit_pos & np.uint64(31)
    lo = (v << bit_off) & np.uint64(0xFFFFFFFF)
    hi = v >> (np.uint64(32) - bit_off)  # bit_off == 0 -> shift by 32: handle below
    hi = np.where(bit_off == 0, np.uint64(0), hi)
    np.bitwise_or.at(out, word_idx, lo)
    np.bitwise_or.at(out, word_idx + 1, hi)
    return out.astype(np.uint32)


def bitunpack(packed: np.ndarray, n: int, width: int) -> np.ndarray:
    """Inverse of `bitpack` -> uint32 array of n values. Numpy oracle."""
    packed64 = packed.astype(np.uint64)
    bit_pos = np.arange(n, dtype=np.uint64) * np.uint64(width)
    word_idx = (bit_pos >> np.uint64(5)).astype(np.int64)
    bit_off = bit_pos & np.uint64(31)
    lo = packed64[word_idx] >> bit_off
    hi = packed64[word_idx + 1] << (np.uint64(32) - bit_off)
    hi = np.where(bit_off == 0, np.uint64(0), hi)
    mask = (np.uint64(1) << np.uint64(width)) - np.uint64(1)
    return ((lo | hi) & mask).astype(np.uint32)


def dict_encode(values: np.ndarray) -> tuple[np.ndarray, np.ndarray, int]:
    """Dictionary-encode int values -> (dictionary, packed_codes, code_width)."""
    dictionary, codes = np.unique(np.asarray(values), return_inverse=True)
    code_width = width_for(max(len(dictionary) - 1, 1))
    packed = bitpack(codes.astype(np.uint64), code_width)
    return dictionary.astype(np.int32), packed, code_width


def dict_decode(
    dictionary: np.ndarray, packed_codes: np.ndarray, n: int, code_width: int
) -> np.ndarray:
    codes = bitunpack(packed_codes, n, code_width).astype(np.int64)
    return dictionary[codes]


def bytesplit_encode(values: np.ndarray) -> np.ndarray:
    """float32 -> byte planes, returned as a uint32 word array (4 planes)."""
    v = np.ascontiguousarray(values.astype(np.float32))
    raw = v.view(np.uint8).reshape(-1, 4)
    n = raw.shape[0]
    # plane-major layout: [all byte0][all byte1][all byte2][all byte3]
    planes = raw.T.reshape(-1)  # (4*n,) uint8
    pad = (-planes.shape[0]) % 4
    if pad:
        planes = np.concatenate([planes, np.zeros(pad, dtype=np.uint8)])
    return planes.view(np.uint32).copy(), n  # type: ignore[return-value]


def bytesplit_decode(words: np.ndarray, n: int) -> np.ndarray:
    planes = words.view(np.uint8)[: 4 * n].reshape(4, n)
    raw = planes.T.reshape(-1).copy()
    return raw.view(np.float32).copy()


def plain_f32_encode(values: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(values.astype(np.float32)).view(np.uint32).copy()


def plain_f32_decode(words: np.ndarray, n: int) -> np.ndarray:
    return words[:n].view(np.float32).copy()
