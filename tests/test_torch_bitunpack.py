"""The arithmetic of the bit-packed tile kernels (``bitunpack`` in
``csrc/decode.cu`` and ``fused_sparse`` in ``csrc/fused.cu``, both built on
``unpack_tile`` in ``csrc/common.cuh``), mirrored in numpy and held against
the JAX package's plain oracle ``repro.kernels.ref.bitunpack_grouped``.

A CUDA kernel cannot run here, so the mirror repeats, step for step, what one
block and one lane do: the tile's geometry (``kTileGroups`` groups of one
feature per block, ``tile_grid``; the tile goes by one bulk copy or by 4-byte
loads, ``bulk_ok``) and lane j's extraction of value j from the staged words
(``LaneBits``: the clamped ``hi`` word, a 64-bit funnel shift right by
``off``, the mask).  The tile size is read from the header.  The chip run
(``chip_smoke.py``) holds the kernels themselves against the port's plain
versions at the cases below.
"""

import re
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.kernels import ref as jref

ROOT = Path(__file__).resolve().parents[1]
HEADER = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "common.cuh"
TILE_GROUPS = int(re.search(r"constexpr int kTileGroups = (\d+);", HEADER.read_text())[1])
WIDTHS = range(1, 33)


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def _words(seed, shape):
    return np.random.default_rng(seed).integers(0, 2**32, size=shape, dtype=np.uint32)


def lane_bits(width: int):
    """LaneBits(width) for lanes 0..31: (lo, hi, off, mask)."""
    bit = np.arange(32) * width
    lo, off = bit >> 5, bit & 31
    hi = np.minimum(lo + 1, width - 1)
    return lo, hi, off, np.uint32(0xFFFFFFFF >> (32 - width))


def funnelshift_r(lo: np.ndarray, hi: np.ndarray, off: np.ndarray) -> np.ndarray:
    """``__funnelshift_r``: the low 32 bits of (hi:lo) >> (off & 31)."""
    cat = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return (cat >> (off.astype(np.uint64) & np.uint64(31))).astype(np.uint32)


def tiles(f: int, g: int):
    """Every block's tile: (first group of the tile in the flat (F*G)
    order, number of groups)."""
    for fi in range(f):
        for g0 in range(0, g, TILE_GROUPS):
            yield fi * g + g0, min(TILE_GROUPS, g - g0)


def mirror_unpack(words: np.ndarray) -> np.ndarray:
    """(F, G, W) uint32 words -> (F, G, 32) uint32, as the kernel computes
    them: tile by tile, each staged as one contiguous range of words, every
    lane extracting its value from every group of the tile."""
    f, g, width = words.shape
    flat = words.reshape(-1)
    out = np.full(f * g * 32, 0xDEADBEEF, dtype=np.uint32)  # torch.empty's garbage
    lo, hi, off, mask = lane_bits(width)
    for first, n in tiles(f, g):
        staged = flat[first * width:(first + n) * width].reshape(n, width)
        vals = funnelshift_r(staged[:, lo], staged[:, hi], np.broadcast_to(off, (n, 32))) & mask
        out[first * 32:(first + n) * 32] = vals.reshape(-1)
    return out.reshape(f, g, 32)


@pytest.mark.parametrize("width", WIDTHS)
def test_lane_extraction_matches_reference_every_width(width):
    """Seeded random words and all-ones words, at G = 1, 130 and 8192 + 5
    (ragged tails behind full tiles), equal the oracle; the clamp of ``hi``
    into the group is exact because a lane that does not straddle a word
    edge takes from ``hi`` only bits at or above bit W."""
    lo, hi, off, _ = lane_bits(width)
    straddle = off + width > 32
    assert (hi <= width - 1).all() and (hi[straddle] == lo[straddle] + 1).all()
    for g in (1, 130, 8192 + 5):
        for w in (_words(width * 100 + g, (3, g, width)),
                  np.full((3, g, width), 0xFFFFFFFF, dtype=np.uint32)):
            want = np.asarray(jref.bitunpack_grouped(w, width))
            np.testing.assert_array_equal(mirror_unpack(w), want)


@pytest.mark.parametrize("width", WIDTHS)
def test_chip_smoke_cases_reach_both_staging_paths(width):
    """The bit-packed cases chip_smoke.py runs at this width reach both of
    the kernel's staging paths: some tile goes by one bulk copy (start and
    length multiples of 16 bytes), and some by 4-byte loads.  Aligned words
    start at a 16-byte boundary; an offset view starts 4 bytes past one, and
    then no tile may go by bulk copy."""
    smoke = _chip_smoke()
    bulk = loads = 0
    for cases, base in ((smoke.BITUNPACK_CASES, 0), (smoke.BITPACK_OFFSET_CASES, 4)):
        for f, g, widths in cases:
            if width not in widths:
                continue
            for first, n in tiles(f, g):
                ok = (base + first * width * 4) % 16 == 0 and (n * width) % 4 == 0
                assert not (ok and base), (f, g, width)
                bulk += ok
                loads += not ok
    assert bulk and loads, (width, bulk, loads)
