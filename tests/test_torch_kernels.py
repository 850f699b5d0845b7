"""The port's fused kernels, through their plain PyTorch versions on the CPU,
against the JAX package's Pallas kernels (run in interpret mode on the CPU).

Inputs are arbitrary uint32 words made with numpy, so NaN, +-inf and
denormals reach every decode.  Integer outputs must match bitwise; ``dense``
to rtol=atol=1e-6 with NaN equal, since log1p may differ by 1 ulp between the
two libraries.
"""

import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.data import encoding as enc
from repro_torch.kernels import ops, ref

DENSE_TOL = dict(rtol=1e-6, atol=1e-6, equal_nan=True)
WIDTHS = (1, 6, 7, 17, 24, 31, 32)


def _words(seed, shape):
    return np.random.default_rng(seed).integers(0, 2**32, size=shape, dtype=np.uint32)


def _params(seed, f):
    rng = np.random.default_rng(seed)
    seeds = rng.integers(0, 2**32, size=f, dtype=np.uint32)
    maxes = rng.integers(1, 2**32, size=f, dtype=np.uint32)
    return seeds, maxes


def _sorted_bounds(seed, f, m):
    """Sorted, NaN-free boundaries spanning the float range, with repeats."""
    rng = np.random.default_rng(seed)
    v = np.sign(rng.standard_normal((f, m))) * 10.0 ** rng.uniform(-40, 38, (f, m))
    v[:, 1::5] = v[:, ::5][:, : v[:, 1::5].shape[1]]
    return np.sort(v.astype(np.float32), axis=-1)


def _t(words):
    return torch.from_numpy(words.view(np.int32))


def _group(values):
    """float32 values (multiple of 4) -> one feature's (1, G, 4) plane words."""
    planes, n = enc.bytesplit_encode(np.asarray(values, np.float32))
    return ops.regroup_bytesplit(planes, n)[None]


@pytest.mark.parametrize("g", [1, 130])
def test_fused_dense_matches_reference(g):
    w = _words(g, (3, g, 4))
    want = np.asarray(jops.fused_dense(w))
    got = ops.fused_dense(_t(w))
    assert got.shape == (3, g * 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **DENSE_TOL)
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))


@pytest.mark.parametrize("g", [1, 130])
@pytest.mark.parametrize("width", WIDTHS)
def test_fused_sparse_matches_reference(width, g):
    w = _words(width * 1000 + g, (3, g, width))
    seeds, maxes = _params(width, 3)
    want = np.asarray(jops.fused_sparse(w, seeds, maxes, width=width))
    got = ops.fused_sparse(_t(w), seeds, maxes, width=width)
    assert got.shape == (3, g * 32) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("g", [1, 130])
@pytest.mark.parametrize("m", [32, 600])  # 600: the 512-chunk loop + remainder
def test_fused_gen_matches_reference(m, g):
    w = _words(m + g, (3, g, 4))
    bounds = _sorted_bounds(m, 3, m)
    seeds, maxes = _params(m, 3)
    want = np.asarray(jops.fused_gen(w, bounds, seeds, maxes))
    got = ops.fused_gen(_t(w), bounds, seeds, maxes)
    assert got.shape == (3, g * 4) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_c1_bucketize_counts_inf_padding_not_nan():
    """+inf counts every boundary, the +inf padding to 128 included; NaN
    counts nothing.  ``torch.searchsorted(right=True)`` gives another answer
    on both, so neither the plain version nor the kernel may use it."""
    x = torch.tensor([np.nan, np.inf, -np.inf, 1.0], dtype=torch.float32)
    bounds = np.asarray([[0.5, 1.0, 2.0, 3.0]], np.float32)
    padded = ops.pad_boundaries(bounds, torch.device("cpu"))
    assert padded.shape == (1, 128)
    assert ref.bucketize(x, padded[0]).tolist() == [0, 128, 0, 2]
    assert torch.searchsorted(torch.from_numpy(bounds[0]), x, right=True).tolist() == [4, 4, 0, 2]
    np.testing.assert_array_equal(
        np.asarray(jops.bucketize(x.numpy()[None], bounds))[0], [0, 128, 0, 2]
    )
    # through the fused chain: the hash of the counts, as the reference
    w = _group(x.numpy())
    seed, big = 12345, 2**32 - 1
    got = ops.fused_gen(_t(w), bounds, [seed], [big])[0]
    assert torch.equal(got, ref.sigridhash(torch.tensor([0, 128, 0, 2]), seed, big))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jops.fused_gen(w, bounds, [seed], [big]))[0]
    )
    # m = 1024 needs no padding: NaN -> 0, +inf -> 1024
    bounds = np.linspace(-1, 1, 1024, dtype=np.float32)[None]
    w = _group([np.nan, np.inf, 0.0, 1e30])
    got = ops.fused_gen(_t(w), bounds, [seed], [big])[0]
    assert torch.equal(got, ref.sigridhash(torch.tensor([0, 1024, 512, 1024]), seed, big))


def test_subnormals_bucketize_as_zero():
    """The reference's compares (XLA on the CPU, as on the TPU) see subnormal
    values and boundaries as zero; the port flushes both alike."""
    x = torch.tensor([-5e-40, 5e-40, 1e-45, -0.0], dtype=torch.float32)
    bounds = np.asarray([[-1e-39, 0.0, 1e-39, 1.0]], np.float32)
    padded = ops.pad_boundaries(bounds, torch.device("cpu"))
    np.testing.assert_array_equal(
        np.asarray(jops.bucketize(x.numpy()[None], bounds))[0], [3, 3, 3, 3]
    )
    assert ref.bucketize(x, padded[0]).tolist() == [3, 3, 3, 3]
    w = _group(x.numpy())
    np.testing.assert_array_equal(
        ops.fused_gen(_t(w), bounds, [5], [1000]).numpy(),
        np.asarray(jops.fused_gen(w, bounds, [5], [1000])),
    )


def test_c5_fused_dense_keeps_nan():
    """log1p(max(x, 0)) keeps NaN, as ``jnp.maximum`` does (CUDA's fmaxf
    would not); negatives and -inf go to 0, +inf stays."""
    w = _group([np.nan, -1.0, -np.inf, np.inf])
    got = ops.fused_dense(_t(w))[0]
    assert torch.isnan(got[0])
    assert got[1:].tolist() == [0.0, 0.0, float("inf")]
    np.testing.assert_allclose(got.numpy(), np.asarray(jops.fused_dense(w))[0], **DENSE_TOL)


def test_plain_versions_match_jax_oracles():
    """The port's ref twins of ``repro.kernels.ref`` on arbitrary words."""
    from repro.kernels import ref as jref

    w = _words(7, (2, 9, 4))
    got = ref.bytesplit_decode_grouped(_t(w)).numpy().view(np.uint32)
    want = np.asarray(jref.bytesplit_decode_grouped(w)).view(np.uint32)
    np.testing.assert_array_equal(got, want)
    for width in WIDTHS:
        p = _words(width, (2, 5, width))
        np.testing.assert_array_equal(
            ref.bitunpack_grouped(_t(p), width).numpy().view(np.uint32),
            np.asarray(jref.bitunpack_grouped(p, width)),
        )
    v = _words(8, (1000,)).view(np.int32)
    for seed, mx in ((0, 1000), (2654435761, 500_000), (7, 2**32 - 1)):
        np.testing.assert_array_equal(
            ref.sigridhash(torch.from_numpy(v), seed, mx).numpy(),
            np.asarray(jref.sigridhash(v, seed, mx)),
        )


def test_boundaries_pad_with_inf_to_128():
    b = ops.pad_boundaries(np.zeros((2, 600), np.float32), torch.device("cpu"))
    assert b.shape == (2, 640)
    assert torch.isinf(b[:, 600:]).all() and (b[:, 600:] > 0).all()
    assert ops.pad_boundaries(np.zeros((1, 256), np.float32), torch.device("cpu")).shape == (1, 256)


# -- the standalone passes of the host lowering ---------------------------------


def _bits(x) -> np.ndarray:
    """Bit patterns of a decode's output, so NaN payloads compare exactly."""
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view(np.int32)


@pytest.mark.parametrize("g", [1, 130])
@pytest.mark.parametrize("width", WIDTHS)
def test_decode_bitpack_matches_reference(width, g):
    w = _words(width * 7 + g, (3, g, width))
    want = np.asarray(jops.decode_bitpack(w, width=width))
    got = ops.decode_bitpack(_t(w), width=width)
    assert got.shape == (3, g * 32) and got.dtype == torch.int32
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("g", [1, 130])
def test_decode_bytesplit_matches_reference_bitwise(g):
    w = _words(100 + g, (3, g, 4))
    want = np.asarray(jops.decode_bytesplit(w))
    got = ops.decode_bytesplit(_t(w))
    assert got.shape == (3, g * 4) and got.dtype == torch.float32
    assert g == 1 or np.isnan(want).any()  # arbitrary words reach NaN payloads
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("n", [1, 1500])  # not multiples of the 1024 tile
def test_sigridhash_matches_reference(n):
    v = _words(n, (3, n)).view(np.int32)
    seeds, maxes = _params(n, 3)
    want = np.asarray(jops.sigridhash(v, seeds, maxes))
    got = ops.sigridhash(torch.from_numpy(v), seeds, maxes)
    assert got.shape == (3, n) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("r", [5, 1500])
@pytest.mark.parametrize("m", [32, 600])
def test_bucketize_matches_reference(m, r):
    x = _words(m * 3 + r, (3, r)).view(np.float32)
    bounds = _sorted_bounds(m + 1, 3, m)
    want = np.asarray(jops.bucketize(x, bounds))
    got = ops.bucketize(torch.from_numpy(x), bounds)
    assert got.shape == (3, r) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_lognorm_matches_reference_any_shape():
    x = _words(11, (3, 5, 7)).view(np.float32)
    want = np.asarray(jops.lognorm(x))
    got = ops.lognorm(torch.from_numpy(x))
    assert got.shape == (3, 5, 7) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **DENSE_TOL)
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))


def test_c1_standalone_bucketize_counts_inf_padding_not_nan():
    """The standalone pass pads to 128 with +inf as the fused one does, so
    +inf counts the padding and NaN counts nothing."""
    x = np.asarray([[np.nan, np.inf, -np.inf, 1.0]], np.float32)
    bounds = np.asarray([[0.5, 1.0, 2.0, 3.0]], np.float32)
    assert ops.bucketize(torch.from_numpy(x), bounds).tolist() == [[0, 128, 0, 2]]
    np.testing.assert_array_equal(np.asarray(jops.bucketize(x, bounds)), [[0, 128, 0, 2]])
    bounds = np.linspace(-1, 1, 1024, dtype=np.float32)[None]
    x = np.asarray([[np.nan, np.inf, 0.0, 1e30]], np.float32)
    assert ops.bucketize(torch.from_numpy(x), bounds).tolist() == [[0, 1024, 512, 1024]]


def test_c6_standalone_bucketize_subnormals_as_zero():
    x = np.asarray([[-5e-40, 5e-40, 1e-45, -0.0]], np.float32)
    bounds = np.asarray([[-1e-39, 0.0, 1e-39, 1.0]], np.float32)
    got = ops.bucketize(torch.from_numpy(x), bounds)
    assert got.tolist() == [[3, 3, 3, 3]]
    np.testing.assert_array_equal(got.numpy(), np.asarray(jops.bucketize(x, bounds)))


def test_c5_standalone_lognorm_keeps_nan():
    x = torch.tensor([np.nan, -1.0, -np.inf, np.inf, 0.0], dtype=torch.float32)
    got = ops.lognorm(x)
    assert torch.isnan(got[0])
    assert got[1:].tolist() == [0.0, 0.0, float("inf"), 0.0]
    np.testing.assert_allclose(got.numpy(), np.asarray(jops.lognorm(x.numpy())), **DENSE_TOL)


def test_standalone_ops_take_views():
    """Transposed and offset views give the values of their contiguous
    copies (the CUDA bindings take offset views through 4-byte accesses)."""
    w = _t(_words(3, (2, 9, 4)))
    flat = torch.from_numpy(_words(4, (1 + 2 * 9 * 4,)).view(np.int32))
    offset = flat[1:].view(2, 9, 4)  # contiguous, 4 bytes past the buffer start
    assert torch.equal(_bits_t(ops.decode_bytesplit(offset)),
                       _bits_t(ops.decode_bytesplit(offset.clone())))
    x = ops.decode_bytesplit(w)
    assert torch.equal(ops.sigridhash(x.view(torch.int32).t(), [1] * 36, [97] * 36),
                       ops.sigridhash(x.view(torch.int32).t().contiguous(), [1] * 36, [97] * 36))
    torch.testing.assert_close(ops.lognorm(x.t()), ops.lognorm(x.t().contiguous()),
                               rtol=0, atol=0, equal_nan=True)
    bounds = np.sort(np.random.default_rng(5).standard_normal((36, 40)).astype(np.float32))
    assert torch.equal(ops.bucketize(x.t(), bounds), ops.bucketize(x.t().contiguous(), bounds))


def _bits_t(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32)


def test_plain_sigridhash_params_matches_per_feature_hash():
    v = torch.from_numpy(_words(9, (3, 50)).view(np.int32))
    seeds, maxes = _params(9, 3)
    params = ops.hash_params(seeds, maxes, torch.device("cpu"))
    got = ref.sigridhash_params(v, params)
    for f in range(3):
        assert torch.equal(got[f], ref.sigridhash(v[f], int(seeds[f]), int(maxes[f])))


def test_launch_counts_lose_no_update_across_threads():
    """Loader threads launch concurrently; every count lands."""
    import sys
    import threading

    from repro_torch.kernels import _binding

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    _binding.reset_launches()
    try:
        def bump():
            for _ in range(20_000):
                _binding.count("fused_dense")

        threads = [threading.Thread(target=bump) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert _binding.LAUNCHES["fused_dense"] == 8 * 20_000
    finally:
        sys.setswitchinterval(old)
        _binding.reset_launches()
