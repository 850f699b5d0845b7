"""The port's data side against the JAX package's: the same (cfg, rows, seed,
pid) gives bitwise the same partitions and staged pages, and a JAX spec
carries across through ``spec_from_arrays``."""

import dataclasses

import numpy as np
import pytest

from repro.configs import recsys_rm as jconfigs
from repro.core.preprocess import pages_from_partition as j_pages
from repro.core.spec import TransformSpec as JSpec
from repro.data import synth as jsynth
from repro.data.columnar import decode_partition_numpy as j_decode
from repro.data.storage import PartitionedStore as JStore
from repro_torch.configs import recsys_rm as pconfigs
from repro_torch.core.preprocess import pages_from_partition as p_pages
from repro_torch.core.spec import TransformSpec as PSpec
from repro_torch.core.spec import spec_from_arrays
from repro_torch.data import synth as psynth
from repro_torch.data.columnar import decode_partition_numpy as p_decode
from repro_torch.data.storage import PartitionedStore as PStore

SMALL = dict(name="t", n_dense=4, n_sparse=3, avg_sparse_len=4, max_sparse_len=8,
             n_generated=2, bucket_size=32, id_space=1 << 16, embedding_rows=1024,
             rows_per_partition=256)


def _sources(kind):
    """(JAX source, port source) for one geometry."""
    if kind == "small_rm":
        return (jsynth.SyntheticRecSysSource(jsynth.RMDataConfig(**SMALL), rows=256),
                psynth.SyntheticRecSysSource(psynth.RMDataConfig(**SMALL), rows=256))
    if kind == "small_rm_dedup":
        cfg = dict(SMALL, dup_factor=4, dup_pool=16)
        return (jsynth.SyntheticRecSysSource(jsynth.RMDataConfig(**cfg), rows=256, seed=3),
                psynth.SyntheticRecSysSource(psynth.RMDataConfig(**cfg), rows=256, seed=3))
    assert kind == "rm1"  # full width, 8192 rows
    return jsynth.make_rm_source("rm1", seed=1), psynth.make_rm_source("rm1", seed=1)


def _spec_arrays(spec):
    return {
        "bucket_boundaries": spec.bucket_boundaries,
        "generated_source": np.asarray(spec.generated_source),
        "sparse_seeds": spec.sparse_seeds,
        "sparse_max": spec.sparse_max,
        "gen_seeds": spec.gen_seeds,
        "gen_max": spec.gen_max,
    }


def _assert_same_arrays(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("kind", ["small_rm", "small_rm_dedup", "rm1"])
def test_partitions_bitwise_equal_reference(kind):
    jsrc, psrc = _sources(kind)
    assert dataclasses.asdict(jsrc.cfg) == dataclasses.asdict(psrc.cfg)
    np.testing.assert_array_equal(jsrc.bucket_boundaries, psrc.bucket_boundaries)
    np.testing.assert_array_equal(jsrc.generated_source, psrc.generated_source)
    for pid in (0, 5):
        jp, pp = jsrc.partition(pid), psrc.partition(pid)
        assert dataclasses.asdict(jp.schema) == dataclasses.asdict(pp.schema)
        _assert_same_arrays(jp.page_arrays(), pp.page_arrays())
        assert jp.nbytes() == pp.nbytes()
        jd, pd = j_decode(jp), p_decode(pp)
        for group in ("dense", "sparse_values", "sparse_lengths"):
            _assert_same_arrays(jd[group], pd[group])


@pytest.mark.parametrize("kind", ["small_rm", "small_rm_dedup", "rm1"])
def test_pages_from_partition_bitwise_equal_reference(kind):
    jsrc, psrc = _sources(kind)
    jspec, pspec = JSpec.from_source(jsrc), PSpec.from_source(psrc)
    _assert_same_arrays(
        j_pages(jsrc.partition(2), jspec), p_pages(psrc.partition(2), pspec)
    )


def test_spec_from_arrays_round_trips_a_jax_spec():
    jsrc, psrc = _sources("small_rm")
    jspec = JSpec.from_source(jsrc)
    spec = spec_from_arrays(dataclasses.asdict(jspec.cfg), _spec_arrays(jspec))
    assert dataclasses.asdict(spec.cfg) == dataclasses.asdict(jspec.cfg)
    assert spec.generated_source == jspec.generated_source
    _assert_same_arrays(
        {k: v for k, v in _spec_arrays(spec).items() if k != "generated_source"},
        {k: v for k, v in _spec_arrays(jspec).items() if k != "generated_source"},
    )
    # and equals the port's own spec of the port's own source
    own = PSpec.from_source(psrc)
    _assert_same_arrays(_spec_arrays(own), _spec_arrays(spec))


def test_spec_from_arrays_rejects_wrong_shapes():
    jspec = JSpec.from_source(_sources("small_rm")[0])
    arrays = dict(_spec_arrays(jspec), sparse_max=np.ones(7, np.uint32))
    with pytest.raises(ValueError, match="sparse_max"):
        spec_from_arrays(dataclasses.asdict(jspec.cfg), arrays)


def test_store_ownership_and_bytes_match_reference():
    jsrc, psrc = _sources("small_rm")
    js, ps = JStore(8, 3, jsrc), PStore(8, 3, psrc)
    assert [js.owner_of(p) for p in range(8)] == [ps.owner_of(p) for p in range(8)]
    assert [js.partitions_of(d) for d in range(3)] == [ps.partitions_of(d) for d in range(3)]
    for pid in (0, 4, 7):
        _assert_same_arrays(js.read(pid).page_arrays(), ps.read(pid).page_arrays())
    assert js.bytes_read == ps.bytes_read > 0
    with pytest.raises(IndexError):
        ps.read(8)


def test_reduced_configs_match_reference():
    """The model configs, full and reduced, equal the reference's field for
    field, their data configs included."""
    for name in ("rm1", "rm2", "rm5"):
        for ours, theirs in ((pconfigs.CONFIGS[name], jconfigs.CONFIGS[name]),
                             (pconfigs.REDUCED[name], jconfigs.REDUCED[name])):
            assert dataclasses.asdict(ours.data) == dataclasses.asdict(theirs.data)
            assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
