"""The arithmetic of the bucket tile kernels (``bucketize`` in
``csrc/bucketize.cu`` and ``fused_gen`` in ``csrc/fused.cu``, both built on
``bucket_tile`` in ``csrc/common.cuh``), mirrored in numpy and held against
the JAX package's oracles ``repro.kernels.ref.bucketize``, compiled (and, for
``fused_gen``, ``bytesplit_decode_grouped`` and ``sigridhash``).

A CUDA kernel cannot run here, so the mirror repeats, step for step, what one
block and one thread do: the thread-to-value mapping (block (x, f) takes
``kBucketThreads * kBucketValues`` consecutive values of feature f, thread t
values [V t, V t + V), a ragged tail masked), the staging of the boundaries
as a breadth-first (Eytzinger) tree (``tree_levels``, ``tree_slot``, NaN in
the unused slots, the last boundary apart), and the search (L steps of
k = 2k + 1 + (s[k] <= x), then k - N plus the last boundary's compare, with
subnormal operands read as zero).  For m > 32768, whose tree does not fit
in shared memory, the kernels stage nothing and search the sorted
boundaries in device memory (``bucket_counts_global``: a branchless search
of fixed trip count, then one more probe); the binding chooses the mode
(``_binding.bucket_staged``), and the mirror takes the same choice.  The
block geometry is read from the header.  The chip run (``chip_smoke.py``) holds the kernels themselves
against the port's plain versions at the cases below.
"""

import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels import ref as jref
from repro_torch.kernels._binding import MAX_SHARED_BYTES, bucket_staged

ROOT = Path(__file__).resolve().parents[1]
HEADER = (ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "common.cuh").read_text()
THREADS = int(re.search(r"constexpr int kBucketThreads = (\d+);", HEADER)[1])
VALUES = int(re.search(r"constexpr int kBucketValues = (\d+);", HEADER)[1])
NAN = np.float32(np.nan)
TINY = np.finfo(np.float32).tiny
# the oracle compiled, as the reference's kernels run it: compiled, XLA on the
# CPU reads subnormal operands as zero (C6); dispatched op by op, it compares
# them exactly
BUCKETIZE = jax.jit(jref.bucketize)
# unpadded counts, then every count ops.pad_boundaries gives at rm1..rm5 and
# at the tests' 600, then counts searched in device memory: the first
# (32769), padded (65536) and unpadded (40001)
M_CASES = (0, 1, 3, 127, 129, 128, 640, 1024, 2048, 4096, 32769, 40001, 65536)


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def flush(a: np.ndarray) -> np.ndarray:
    """Subnormal -> 0, as the ``.ftz`` compare reads its operands."""
    a = np.asarray(a, np.float32)
    return np.where(np.abs(a) < TINY, np.float32(0), a)


def tree_levels(m: int) -> int:
    """``tree_levels``: L = ceil(log2 m), 32 - clz(m - 1) for m > 1."""
    return (m - 1).bit_length() if m > 1 else 0


def tree_slot(i: np.ndarray, levels: int) -> np.ndarray:
    """``tree_slot``: in-order i, i + 1 = (2j + 1) 2^t, to slot 2^(L-1-t) - 1 + j."""
    i1 = np.asarray(i) + 1
    t = np.log2(i1 & -i1).astype(np.int64)  # __ffs(i + 1) - 1
    return (1 << (levels - 1 - t)) - 1 + (i1 >> (t + 1))


def stage_tree(b: np.ndarray) -> np.ndarray:
    """``stage_tree``: one feature's m boundaries -> the 2^L staged slots
    (slot N = 2^L - 1 holds the last boundary; unused tree slots NaN)."""
    m = len(b)
    levels = tree_levels(m)
    nodes = (1 << levels) - 1
    s = np.full(nodes + 1 if m else 0, NAN, np.float32)
    i = np.arange(max(m - 1, 0))
    written = np.zeros(len(s), int)
    np.add.at(written, tree_slot(i, levels), 1)
    s[tree_slot(i, levels)] = b[: m - 1]
    if m:
        s[nodes] = b[m - 1]
        written[nodes] += 1
    # every boundary lands in its own slot; the rest are the NaN fill
    assert (written <= 1).all() and written.sum() == m
    return s


def in_order(nodes: int) -> list:
    """The slots of a breadth-first tree of `nodes` nodes (children of k at
    2k + 1 and 2k + 2) in the order of an in-order walk."""
    order, stack, k = [], [], 0
    while stack or k < nodes:
        while k < nodes:
            stack.append(k)
            k = 2 * k + 1
        k = stack.pop()
        order.append(k)
        k = 2 * k + 2
    return order


def bucket_counts(s: np.ndarray, m: int, x: np.ndarray) -> np.ndarray:
    """``bucket_counts`` for every value of x at once."""
    levels = tree_levels(m)
    nodes = (1 << levels) - 1
    fs, fx = flush(s), flush(x)
    k = np.zeros(len(fx), np.int64)
    for _ in range(levels):
        k = 2 * k + 1 + (fs[k] <= fx)  # NaN compares false
    last = fs[nodes] if m else NAN
    return (k - nodes + (last <= fx)).astype(np.int32)


def global_counts(b: np.ndarray, x: np.ndarray) -> np.ndarray:
    """``bucket_counts_global`` for every value of x at once: m - 1 >= 0
    boundaries in device memory; while n > 1, probe b[base + n/2] and move
    base up by n/2 if it is <= x, n -= n/2; then count base plus the last
    probe, b[base] <= x.  Every probe lies inside the row."""
    m = len(b)
    fb, fx = flush(b), flush(x)
    base = np.zeros(len(fx), np.int64)
    n = m
    while n > 1:
        half = n >> 1
        assert (base + half < m).all()
        base += np.where(fb[base + half] <= fx, half, 0)  # NaN compares false
        n -= half
    return (base + (fb[base] <= fx)).astype(np.int32)


def counts_of(b: np.ndarray, x: np.ndarray) -> np.ndarray:
    """One feature's counts in the mode the binding chooses for its m."""
    m = len(b)
    if bucket_staged(m):
        return bucket_counts(stage_tree(b), m, x)
    return global_counts(b, x)


def tiles(n: int):
    """Each live thread of one feature's blocks: (first value k, how many of
    its V values lie before n)."""
    per_block = THREADS * VALUES
    for bx in range(-(-n // per_block)):
        k = (bx * THREADS + np.arange(THREADS)) * VALUES
        for kk in k[k < n]:
            yield int(kk), min(VALUES, n - int(kk))


def mirror_bucketize(values: np.ndarray, bounds: np.ndarray) -> np.ndarray:
    """(F, R) f32 values + (F, m) boundaries -> (F, R) counts, thread by
    thread; a value no thread stores stays at the sentinel."""
    f, r = values.shape
    out = np.full((f, r), -1, np.int32)
    for fi in range(f):
        counts = counts_of(bounds[fi], values[fi])
        for k, live in tiles(r):
            out[fi, k:k + live] = counts[k:k + live]
    return out


def bytesplit_values(words: np.ndarray) -> np.ndarray:
    """A group's 4 plane words -> its 4 f32 values: value j takes byte j of
    each plane word (``bytesplit_bits``)."""
    b = words.astype("<u4").view(np.uint8).reshape(*words.shape[:-1], 4, 4)
    return np.ascontiguousarray(b.swapaxes(-1, -2)).view("<f4")[..., 0]


def mirror_fused_gen(words: np.ndarray, bounds: np.ndarray, seeds, maxes) -> np.ndarray:
    """(F, G, 4) words -> (F, G, 4) hashed bucket ids, thread by thread:
    thread value k decodes group k / 4 and stores its V = 4 results as one
    16-byte word."""
    assert VALUES == 4  # one byte-split group per thread
    f, g, _ = words.shape
    out = np.full((f, g * 4), -1, np.int64)
    for fi in range(f):
        x = bytesplit_values(words[fi]).reshape(-1)
        counts = counts_of(bounds[fi], x)
        hashed = np.asarray(jref.sigridhash(jnp.asarray(counts), int(seeds[fi]), int(maxes[fi])))
        for k, live in tiles(4 * g):
            assert live == VALUES
            out[fi, k:k + VALUES] = hashed[k:k + VALUES]
    return out.reshape(f, g, 4).astype(np.int32)


def oracle_bucketize(values: np.ndarray, bounds: np.ndarray) -> np.ndarray:
    return np.stack([np.asarray(BUCKETIZE(values[fi], bounds[fi]))
                     for fi in range(len(values))])


def sorted_bounds(rng, f: int, m: int) -> np.ndarray:
    """Sorted, NaN-free boundaries over the whole float range (subnormals
    and +-inf included), with runs of repeats."""
    v = np.sign(rng.standard_normal((f, m))) * 10.0 ** rng.uniform(-44, 38, (f, m))
    v = v.astype(np.float32)
    v[:, 1::5] = v[:, ::5][:, : v[:, 1::5].shape[1]]
    v[:, 7::11] = np.inf
    v[:, 9::13] = -np.inf
    return np.sort(v, axis=-1)


def adversarial_values(rng, bounds: np.ndarray, n: int) -> np.ndarray:
    """Arbitrary f32 bit patterns, with every feature's boundaries, NaN,
    +-inf, +-0 and subnormals spliced in."""
    f = len(bounds)
    v = rng.integers(0, 2**32, size=(f, n), dtype=np.uint32).view(np.float32).copy()
    edges = np.asarray([np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-45, -1e-45, 5e-40, -5e-40],
                       np.float32)
    v[:, : len(edges)] = edges
    take = min(bounds.shape[1], n - len(edges))
    v[:, len(edges):len(edges) + take] = bounds[:, :take]
    return v


@pytest.mark.parametrize("m", M_CASES)
def test_bucketize_mirror_matches_reference(m):
    """Every value of every feature is stored once, by the thread that owns
    it, with the oracle's count: R = 1, a ragged R behind full blocks, and
    R = 1027 (not a multiple of 4).  Where the tree is staged, an in-order
    walk of it, then the last slot, gives the boundaries back in sorted
    order, the NaN fill apart."""
    rng = np.random.default_rng(m)
    bounds = sorted_bounds(rng, 3, m)
    for b in bounds[: 3 if bucket_staged(m) else 0]:
        s = stage_tree(b)
        walk = s[in_order(len(s) - 1) + [len(s) - 1]] if m else s
        np.testing.assert_array_equal(walk[~np.isnan(walk)], b)
    for r in (1, THREADS * VALUES + 5, 1027):
        values = adversarial_values(rng, bounds, r) if r > 20 else \
            rng.integers(0, 2**32, (3, r), dtype=np.uint32).view(np.float32)
        np.testing.assert_array_equal(mirror_bucketize(values, bounds),
                                      oracle_bucketize(values, bounds))


@pytest.mark.parametrize("m", M_CASES)
def test_fused_gen_mirror_matches_reference(m):
    """The same search behind the byte-split decode and the hash, at G = 1
    and a ragged G = 300 (1,200 values, one full block and a partial one)."""
    rng = np.random.default_rng(1000 + m)
    bounds = sorted_bounds(rng, 3, m)
    seeds = rng.integers(0, 2**32, 3, dtype=np.uint32)
    maxes = rng.integers(1, 2**32, 3, dtype=np.uint32)
    for g in (1, 300):
        words = rng.integers(0, 2**32, (3, g, 4), dtype=np.uint32)
        x = np.asarray(jref.bytesplit_decode_grouped(jnp.asarray(words))).reshape(3, -1)
        np.testing.assert_array_equal(bytesplit_values(words).reshape(3, -1).view(np.uint32),
                                      x.view(np.uint32))
        want = np.stack([np.asarray(jref.sigridhash(BUCKETIZE(x[fi], bounds[fi]),
                                                    int(seeds[fi]), int(maxes[fi])))
                         for fi in range(3)]).reshape(3, g, 4)
        np.testing.assert_array_equal(mirror_fused_gen(words, bounds, seeds, maxes), want)


def test_edge_values_against_reference():
    """C1 and C6 at the search's edges: NaN counts nothing, +inf counts the
    +inf padding, subnormal values and boundaries compare as zero, -0 equals
    +0, a value equal to a run of repeated boundaries counts the whole run."""
    bounds = np.asarray([[-np.inf, -1e-39, -0.0, 0.0, 1e-45, 1.0, 1.0, 1.0, 2.0, np.inf]],
                        np.float32)
    x = np.asarray([[np.nan, np.inf, -np.inf, 0.0, -0.0, 5e-40, -5e-40, 1.0, 2.0, 1.5, 3.0,
                     -1.0]], np.float32)
    want = [0, 10, 1, 5, 5, 5, 5, 8, 9, 8, 9, 1]
    np.testing.assert_array_equal(oracle_bucketize(x, bounds)[0], want)
    np.testing.assert_array_equal(mirror_bucketize(x, bounds)[0], want)
    padded = np.concatenate([bounds, np.full((1, 118), np.inf, np.float32)], axis=1)
    want_padded = np.where(np.isposinf(x[0]), 128, want)
    np.testing.assert_array_equal(oracle_bucketize(x, padded)[0], want_padded)
    np.testing.assert_array_equal(mirror_bucketize(x, padded)[0], want_padded)


def test_chip_smoke_cases_reach_every_access_path():
    """The bucket cases chip_smoke.py runs reach both modes (the tree in
    shared memory, the search in device memory at m = 32769 and 65536), both
    ways of staging the boundaries (16-byte loads where a feature's row is 16-byte aligned, else
    4-byte loads) and both ways of reading bucketize's values (16-byte
    vectors where the base is aligned and R % 4 == 0, else masked 4-byte
    loads), and cover the unpadded counts, a ragged R and every rm width's
    padded m."""
    smoke = _chip_smoke()
    staging = {"gen": set(), "bucketize": set()}
    value_paths = set()
    m_seen = set()

    def bounds_paths(f, m, base):
        return {base % 16 == 0 and (fi * m * 4) % 16 == 0 and m % 4 == 0 for fi in range(f)}

    pad = lambda m: -(-m // 128) * 128  # noqa: E731  (ops.pad_boundaries)
    for f, g, m in smoke.GEN_CASES:
        staging["gen"] |= bounds_paths(f, pad(m), 0)
        m_seen.add(pad(m))
    for f, r, m in smoke.BUCKETIZE_CASES:
        staging["bucketize"] |= bounds_paths(f, pad(m), 0)
        value_paths.add(r % 4 == 0)
        m_seen.add(pad(m))
    for m in smoke.UNPADDED_M:
        staging["gen"] |= bounds_paths(3, m, 0)
        staging["bucketize"] |= bounds_paths(3, m, 0)
    for f, r, m in smoke.BUCKET_OFFSET_CASES:
        staging["gen"] |= bounds_paths(f, pad(m), 4)
        staging["bucketize"] |= bounds_paths(f, pad(m), 4)
        value_paths.add(False)  # the values start 4 bytes past alignment
    modes = {bucket_staged(m) for m in m_seen | set(smoke.UNPADDED_M)}
    modes |= {bucket_staged(m) for _, _, m in smoke.DEVICE_SEARCH_CASES}
    assert modes == {True, False}
    assert {32769, 65536} <= {m for _, _, m in smoke.DEVICE_SEARCH_CASES}
    assert staging == {"gen": {True, False}, "bucketize": {True, False}}
    assert value_paths == {True, False}
    assert {1024, 2048, 4096} <= m_seen
    assert {1, 3, 127, 129} <= set(smoke.UNPADDED_M)
    assert any(r % (THREADS * VALUES) for _, r, _ in smoke.BUCKETIZE_CASES)


def test_binding_checks_the_tree_size():
    """The bindings stage the tree for every boundary count whose tree (m
    rounded up to a power of two slots, ``bucket_smem``) fits in a block's
    shared memory, and search device memory for every other count: they
    refuse no m the kernels' int can hold."""
    for m in (0, 1, 2, 3, 1024, 1025, 32768, 32769, 58112, 65536, 2**31 - 1):
        fits = (4 << tree_levels(m) if m else 0) <= MAX_SHARED_BYTES
        assert bucket_staged(m) == fits
    assert bucket_staged(32768) and not bucket_staged(32769)
    for m in (-1, 2**31):
        with pytest.raises(ValueError):
            bucket_staged(m)


def test_device_memory_search_matches_the_tree():
    """At a count the tree holds, the device-memory search gives the tree's
    counts: the two modes agree wherever both can run, edges included."""
    rng = np.random.default_rng(7)
    for m in (1, 2, 3, 128, 129, 1024, 4097):
        b = sorted_bounds(rng, 1, m)[0]
        x = adversarial_values(rng, b[None], 2000)[0]
        np.testing.assert_array_equal(global_counts(b, x), bucket_counts(stage_tree(b), m, x))
