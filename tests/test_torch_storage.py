"""The port's storage layer against the JAX package's: partition files,
digests and fingerprints, the seeded fault schedules, the simulated devices,
the spill tier's checksums, and the dedup-ref check (C9).

Files are shared: both packages write the same bytes for the same partition
and read each other's.  Content hashes are equal strings.  A fault schedule
is a function of (seed, op, ident, attempt), so the same seed gives the same
faults in both packages.
"""

import json
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.registry import get_recsys as j_get_recsys
from repro.data import columnar as jcol
from repro.data import storage as jstorage
from repro.data import synth as jsynth
from repro_torch.configs.registry import get_recsys
from repro_torch.core.costmodel import ContentionAwareCostModel, partition_costs
from repro_torch.core.featcache import CacheKey, FeatureCache, batch_nbytes
from repro_torch.core.preprocess import pages_from_partition
from repro_torch.core.spec import TransformSpec
from repro_torch.data import storage as pstorage
from repro_torch.data import synth as psynth
from repro_torch.data.columnar import (
    REFS_COLUMN,
    CorruptPartitionFile,
    EncodedColumn,
    Partition,
    block_fingerprints,
    decode_partition_numpy,
    partition_digest,
    read_partition,
    write_partition,
)
from repro_torch.data.storage import (
    CacheSpillStore,
    CorruptPartitionError,
    DeviceFleet,
    DeviceOfflineError,
    IoFaultInjector,
    IspDevice,
    PartitionedStore,
    TransientReadError,
    parse_iofault_spec,
    zipf_owner_map,
)

N_PARTS = 8
SMALL = dict(name="t", n_dense=4, n_sparse=3, avg_sparse_len=4, max_sparse_len=8,
             n_generated=2, bucket_size=32, id_space=1 << 16, embedding_rows=1024,
             rows_per_partition=256)
KINDS = ["small", "small_dedup", "small_dedup_pool", "rm1_reduced"]


def _sources(kind):
    """(JAX source, port source) over one geometry, classic or dedup."""
    if kind == "rm1_reduced":
        return (jsynth.SyntheticRecSysSource(j_get_recsys("rm1", reduced=True).data, rows=192),
                psynth.SyntheticRecSysSource(get_recsys("rm1", reduced=True).data, rows=192))
    cfg = dict(SMALL)
    if kind == "small_dedup":
        cfg.update(dup_factor=4)
    elif kind == "small_dedup_pool":
        cfg.update(dup_factor=4, dup_pool=16)
    return (jsynth.SyntheticRecSysSource(jsynth.RMDataConfig(**cfg), rows=256, seed=3),
            psynth.SyntheticRecSysSource(psynth.RMDataConfig(**cfg), rows=256, seed=3))


@pytest.fixture(scope="module")
def rm1():
    """Reduced rm1 at 192 rows (the reference's fault-domain fixture)."""
    jsrc, src = _sources("rm1_reduced")
    return {"src": src, "jsrc": jsrc, "spec": TransformSpec.from_source(src)}


def _pages_equal(a, b):
    assert sorted(a.columns) == sorted(b.columns)
    for cname in a.columns:
        pa, pb = a.columns[cname].pages, b.columns[cname].pages
        assert sorted(pa) == sorted(pb)
        for pname in pa:
            np.testing.assert_array_equal(pa[pname], pb[pname], err_msg=f"{cname}/{pname}")


# -- the shared file format ------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_partition_files_are_byte_identical_and_cross_read(kind, tmp_path):
    jsrc, src = _sources(kind)
    for pid in (0, 3):
        jpath, ppath = str(tmp_path / f"j{pid}.rp"), str(tmp_path / f"p{pid}.rp")
        jcol.write_partition(jpath, jsrc.partition(pid))
        write_partition(ppath, src.partition(pid))
        assert open(jpath, "rb").read() == open(ppath, "rb").read()
        from_ref = read_partition(jpath)  # the port reads the reference's file
        to_ref = jcol.read_partition(ppath)  # and the reference the port's
        assert from_ref.partition_id == to_ref.partition_id == pid
        assert from_ref.schema.to_json() == to_ref.schema.to_json()
        _pages_equal(from_ref, to_ref)
        _pages_equal(from_ref, src.partition(pid))


@pytest.mark.parametrize("kind", KINDS)
def test_digests_and_fingerprints_are_equal_strings(kind, tmp_path):
    jsrc, src = _sources(kind)
    assert src.fingerprint() == jsrc.fingerprint()
    jstore = jstorage.PartitionedStore(4, 2, source=jsrc)
    store = PartitionedStore(4, 2, src)
    jfile = jstorage.PartitionedStore(4, 2, source=jsrc, root=str(tmp_path / "j"))
    pfile = PartitionedStore(4, 2, src, root=str(tmp_path / "p"))
    jfile.materialize(range(4))
    pfile.materialize(range(4))
    for pid in range(4):
        part, jpart = src.partition(pid), jsrc.partition(pid)
        assert partition_digest(part) == jcol.partition_digest(jpart)
        assert block_fingerprints(part) == jcol.block_fingerprints(jpart)
        assert store.content_digest(pid) == jstore.content_digest(pid)
        # source-backed identity, then file-backed (a hash of the file's bytes)
        assert store.partition_fingerprint(pid) == jstore.partition_fingerprint(pid)
        assert pfile.partition_fingerprint(pid) == jfile.partition_fingerprint(pid)
        assert pfile.partition_fingerprint(pid) != store.partition_fingerprint(pid)
        for s, js in ((store, jstore), (pfile, jfile)):
            assert s.block_fingerprints(pid) == js.block_fingerprints(pid)
            refs, jrefs = s.block_refs(pid), js.block_refs(pid)
            assert (refs is None) == (jrefs is None)
            if refs is not None:
                np.testing.assert_array_equal(refs, jrefs)
    assert (block_fingerprints(src.partition(0)) is None) == (kind in ("small", "rm1_reduced"))


@pytest.mark.parametrize("kind", KINDS)
def test_schema_sizes_and_logical_bytes_match_reference(kind):
    jsrc, src = _sources(kind)
    part, jpart = src.partition(1), jsrc.partition(1)
    for cs, jcs in zip(part.schema.columns, jpart.schema.columns):
        assert part.schema.page_sizes(cs) == jpart.schema.page_sizes(jcs)
    assert part.schema.encoded_words() == jpart.schema.encoded_words()
    assert part.logical_nbytes() == jpart.logical_nbytes()
    assert part.nbytes() == jpart.nbytes()
    assert part.schema.to_json() == jpart.schema.to_json()
    back = type(part.schema).from_json(jpart.schema.to_json())
    assert back == part.schema


def test_file_store_reads_the_file_first(rm1, tmp_path):
    """A materialized partition is read from its file (generation off the
    read path); the bytes and the byte counters equal the source's."""
    src = rm1["src"]
    store = PartitionedStore(8, num_devices=2, source=src, root=str(tmp_path))
    store.materialize(range(4))
    assert os.path.exists(os.path.join(tmp_path, "device000", "part000002.rp"))
    calls = []
    real = src.partition
    src.partition = lambda pid: calls.append(pid) or real(pid)
    try:
        part = store.read(2)
        assert calls == []  # the file served it
        store.read(5)  # no file: the source
        assert calls == [5]
    finally:
        del src.partition
    _pages_equal(part, src.partition(2))
    assert store.bytes_read == part.nbytes() + src.partition(5).nbytes()
    # a store with files alone (no source) reads them too
    bare = PartitionedStore(8, num_devices=2, root=str(tmp_path))
    _pages_equal(bare.read(2), part)
    with pytest.raises(FileNotFoundError):
        bare.read(6)


# -- test_data.py's partition and disk-store cases, on the port ----------------


def test_partition_roundtrip_all_rms():
    for name in ("rm1", "rm2"):
        src = psynth.make_rm_source(name, rows=128)
        dec = decode_partition_numpy(src.partition(5))
        raw = src.raw(5)
        np.testing.assert_allclose(dec["dense"]["d0"], raw.dense[:, 0])
        np.testing.assert_array_equal(dec["sparse_values"]["s0"], raw.sparse_values[:, 0])
        np.testing.assert_array_equal(dec["sparse_lengths"]["s0"], raw.sparse_lengths[:, 0])
        np.testing.assert_allclose(dec["dense"]["label"], raw.labels)


def test_partition_determinism():
    a = psynth.make_rm_source("rm1", rows=64).raw(7)
    b = psynth.make_rm_source("rm1", rows=64).raw(7)
    np.testing.assert_array_equal(a.sparse_values, b.sparse_values)
    np.testing.assert_allclose(a.dense, b.dense)


def test_disk_store_roundtrip(tmp_path):
    src = psynth.make_rm_source("rm1", rows=64)
    store = PartitionedStore(8, num_devices=2, source=src, root=str(tmp_path))
    store.materialize(range(4))
    dec = decode_partition_numpy(store.read(2))
    np.testing.assert_array_equal(dec["sparse_values"]["s1"], src.raw(2).sparse_values[:, 1])
    assert store.owner_of(2) == 0 and store.owner_of(3) == 1
    assert os.path.exists(os.path.join(tmp_path, "device000", "part000002.rp"))


# -- C9: dedup refs are checked on the host -------------------------------------


def _with_ref(part, index, value):
    """A copy of a dedup partition whose refs page holds `value` at `index`."""
    refs = np.array(part.columns[REFS_COLUMN].pages["refs"], dtype=np.uint32)
    refs[index] = np.uint32(value)
    cols = dict(part.columns)
    cols[REFS_COLUMN] = EncodedColumn(part.columns[REFS_COLUMN].schema, {"refs": refs})
    return Partition(part.partition_id, part.schema, cols)


@pytest.mark.parametrize("bad", ["at_u", "beyond_u", "negative"])
def test_c9_out_of_range_ref_raises_before_staging(bad):
    """The reference's ``jnp.take`` fills a ref >= u with INT_MIN and wraps
    a negative one; the port raises a non-retryable CorruptPartitionError
    from ``pages_from_partition`` and stages no page."""
    jsrc, src = _sources("small_dedup")
    part = src.partition(2)
    u = part.schema.unique_rows
    value = {"at_u": u, "beyond_u": u + 1000, "negative": -1}[bad]
    corrupt = _with_ref(part, 5, value & 0xFFFFFFFF)

    # the reference's gather on the same refs (as staged: int32)
    jref = np.array(part.columns[REFS_COLUMN].pages["refs"]).astype(np.int32)
    jref[5] = np.int32(value)
    blocks = np.arange(u, dtype=np.int32) * 7
    taken = np.asarray(jnp.take(jnp.asarray(blocks), jnp.asarray(jref), axis=0))
    if bad == "negative":
        assert taken[5] == blocks[value]  # wrapped
    else:
        assert taken[5] == np.iinfo(np.int32).min  # filled
    np.testing.assert_array_equal(np.delete(taken, 5), blocks[np.delete(jref, 5)])

    staged = []
    spec = TransformSpec.from_source(src)
    with pytest.raises(CorruptPartitionError, match=r"outside \[0, 64\)") as ei:
        staged.append(pages_from_partition(corrupt, spec))
    assert staged == []
    assert ei.value.pid == 2 and ei.value.retryable is False
    # the untouched partition stages, with its refs in range
    refs = pages_from_partition(part, spec)["sparse_refs"]
    assert refs.min() >= 0 and refs.max() < u


# -- spec parsing and seeded schedules (test_iofaults.py, on the port) ---------


def test_parse_iofault_spec_full():
    inj = parse_iofault_spec(
        "transient=0.2,corrupt=0.1,spill=0.3,slow=0.05:0.01,offline=2@6,seed=7"
    )
    assert inj.transient == 0.2 and inj.corrupt == 0.1 and inj.spill == 0.3
    assert inj.slow == 0.05 and inj.slow_s == 0.01
    assert inj.offline_device == 2 and inj.offline_after == 6
    assert inj.seed == 7
    assert parse_iofault_spec("slow=0.5").slow_s > 0


@pytest.mark.parametrize(
    "bad", ["transient", "transient=x", "offline=2", "offline=a@b", "nope=1", "corrupt=2"]
)
def test_parse_iofault_spec_rejects_malformed(bad):
    with pytest.raises(ValueError):
        parse_iofault_spec(bad)


def _spill_schedule(mod, seed):
    inj = mod.IoFaultInjector(seed=seed, transient=0.5, spill=0.5)
    fails = [inj.on_spill_read(f"k{i}") for i in range(32)]
    arrays = {"a": np.arange(64, dtype=np.int32)}
    corrupted = []
    for i in range(16):
        got = inj.maybe_corrupt_spill(f"w{i}", dict(arrays))
        corrupted.append(not np.array_equal(got["a"], arrays["a"]))
    return fails, corrupted, inj.summary()


def test_injector_same_seed_same_schedule():
    ours = _spill_schedule(pstorage, 3)
    assert ours == _spill_schedule(pstorage, 3)
    assert ours[:2] != _spill_schedule(pstorage, 4)[:2]  # the seed matters
    assert ours == _spill_schedule(jstorage, 3)  # and equals the reference's


@pytest.mark.parametrize("spec", [
    "transient=0.5,seed=3", "transient=0.3,corrupt=0.4,seed=7",
    "corrupt=0.5,slow=0.5:0,seed=11", "transient=0.2,corrupt=0.2,offline=1@5,seed=1",
])
def test_fault_schedules_equal_the_reference(rm1, spec):
    """The same spec and seed give the same outcome on every read attempt,
    the same spill faults, and the same counts, in both packages."""
    def run(mod, src):
        inj = mod.parse_iofault_spec(spec)
        fleet = mod.DeviceFleet(4)
        store = mod.PartitionedStore(N_PARTS, 4, src, fleet=fleet, fault_injector=inj)
        outcomes, digests = [], []
        for pid in range(N_PARTS):
            for _ in range(6):
                try:
                    part = store.read(pid)
                except mod.DeviceOfflineError:
                    outcomes.append("offline")
                    store.allow_failover(pid)
                except mod.IoFaultError as e:
                    outcomes.append(f"{type(e).__name__}:{e.retryable}")
                else:
                    outcomes.append("ok")
                    digests.append(store.content_digest(pid))
        spill = [inj.on_spill_read(f"blk{i}") for i in range(16)]
        return outcomes, digests, spill, inj.summary(), fleet.host_link_bytes > 0

    want = run(jstorage, rm1["jsrc"])
    got = run(pstorage, rm1["src"])
    assert got == want
    assert any(o != "ok" for o in got[0])


# -- partition reads: transient / corrupt / offline -----------------------------


def test_transient_read_retries_to_bitwise_clean_bytes(rm1):
    inj = IoFaultInjector(seed=5, transient=0.5)
    store = PartitionedStore(N_PARTS, 4, rm1["src"], fault_injector=inj)
    clean = PartitionedStore(N_PARTS, 4, rm1["src"])
    transients = 0
    for pid in range(N_PARTS):
        for _attempt in range(64):
            try:
                part = store.read(pid)
                break
            except TransientReadError:
                transients += 1
        else:
            pytest.fail(f"pid {pid} never read through transient=0.5")
        assert partition_digest(part) == partition_digest(clean.read(pid))
    assert transients > 0
    assert inj.summary().get("transient", 0) == transients


def test_torn_read_detected_never_delivered(rm1):
    inj = IoFaultInjector(seed=2, corrupt=1.0)
    store = PartitionedStore(N_PARTS, 4, rm1["src"], fault_injector=inj)
    for _ in range(4):
        with pytest.raises(CorruptPartitionError) as ei:
            store.read(0)
        assert ei.value.retryable
    inj2 = IoFaultInjector(seed=2, corrupt=0.5)
    store2 = PartitionedStore(N_PARTS, 4, rm1["src"], fault_injector=inj2)
    clean = PartitionedStore(N_PARTS, 4, rm1["src"])
    for _ in range(64):
        try:
            part = store2.read(1)
            break
        except CorruptPartitionError:
            continue
    else:
        pytest.fail("never read through corrupt=0.5")
    assert partition_digest(part) == partition_digest(clean.read(1))


def test_torn_copy_never_aliases_the_clean_pages(rm1, tmp_path):
    """The injector flips a word of a COPY: the file-backed partition the
    store read stays clean, so the next attempt verifies."""
    store = PartitionedStore(N_PARTS, 4, rm1["src"], root=str(tmp_path))
    store.materialize([0])
    clean = store.read(0)
    inj = IoFaultInjector(seed=2)
    torn = IoFaultInjector(seed=2, corrupt=1.0).maybe_corrupt_partition(0, clean, 1)
    assert torn is not clean and partition_digest(torn) != partition_digest(clean)
    assert partition_digest(clean) == store.content_digest(0)
    assert inj.maybe_corrupt_partition(0, clean, 1) is clean  # corrupt=0: no copy


def test_slow_read_charges_injected_latency(rm1):
    slept = []
    inj = IoFaultInjector(seed=1, slow=1.0, slow_s=0.25, sleep=slept.append)
    PartitionedStore(N_PARTS, 4, rm1["src"], fault_injector=inj).read(0)
    assert slept == [0.25]

    class Clock:  # an injected sleep that only advances modeled time
        t = 0.0

        def sleep(self, s):
            self.t += s

    clock = Clock()
    inj2 = IoFaultInjector(seed=1, slow=1.0, slow_s=3.0, sleep=clock.sleep)
    t0 = time.perf_counter()
    PartitionedStore(N_PARTS, 4, rm1["src"], fault_injector=inj2).read(0)
    assert clock.t == 3.0 and time.perf_counter() - t0 < 1.0


def test_device_offline_then_failover_reads_charge_host(rm1):
    fleet = DeviceFleet(4)
    inj = IoFaultInjector(seed=0, offline_device=1, offline_after=1)
    store = PartitionedStore(N_PARTS, 4, rm1["src"], fleet=fleet, fault_injector=inj)
    pid = store.partitions_of(1)[0]
    with pytest.raises(DeviceOfflineError) as ei:
        store.read(pid)
    assert ei.value.device == 1 and fleet[1].offline is True
    store.read(store.partitions_of(0)[0])
    assert not store.is_failover(pid)
    store.allow_failover(pid)
    assert store.failover_partitions == [pid]
    host0 = fleet.host_link_bytes
    part = store.read(pid)
    assert fleet.host_link_bytes > host0
    clean = PartitionedStore(N_PARTS, 4, rm1["src"])
    assert partition_digest(part) == partition_digest(clean.read(pid))
    assert inj.summary().get("device_offline") == 1


def test_at_rest_corruption_is_nonretryable(rm1, tmp_path):
    store = PartitionedStore(N_PARTS, 4, rm1["src"], root=str(tmp_path),
                             fault_injector=IoFaultInjector(seed=0))
    store.materialize([0])
    path = store._path(0)
    blob = bytearray(open(path, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    with open(path, "wb") as f:
        f.write(bytes(blob))
    with pytest.raises(CorruptPartitionError) as ei:
        store.read(0)
    assert not ei.value.retryable


# -- columnar decode hardening ---------------------------------------------------


def test_columnar_roundtrip_carries_checksum(rm1, tmp_path):
    part = rm1["src"].partition(0)
    path = str(tmp_path / "p0.col")
    write_partition(path, part)
    assert partition_digest(read_partition(path)) == partition_digest(part)
    with open(path, "rb") as f:
        f.read(8)
        hlen = int.from_bytes(f.read(4), "little")
        header = json.loads(f.read(hlen))
    assert "checksum" in header


def test_columnar_rejects_truncated_bad_magic_and_bitflips(rm1, tmp_path):
    part = rm1["src"].partition(0)
    path = str(tmp_path / "p0.col")
    write_partition(path, part)
    blob = open(path, "rb").read()
    hlen = int.from_bytes(blob[8:12], "little")
    body_start = 12 + hlen

    def write_and_read(payload: bytes):
        bad = str(tmp_path / "bad.col")
        with open(bad, "wb") as f:
            f.write(payload)
        return read_partition(bad)

    for cut in (0, 4, 11, body_start - 1, len(blob) - 1):
        with pytest.raises(CorruptPartitionFile):
            write_and_read(blob[:cut])
    with pytest.raises(CorruptPartitionFile):
        write_and_read(b"NOTMAGIC" + blob[8:])
    step = max(1, (len(blob) - body_start) // 16)
    for off in range(body_start, len(blob), step):
        flipped = bytearray(blob)
        flipped[off] ^= 0x01
        with pytest.raises(CorruptPartitionFile):
            write_and_read(bytes(flipped))


# -- spill-block integrity -------------------------------------------------------


class _Events:
    def __init__(self):
        self.kinds = []

    def emit(self, kind, **data):
        self.kinds.append(kind)


def _block():
    return {
        "dense": np.arange(48, dtype=np.float32).reshape(4, 12),
        "ids": np.arange(64, dtype=np.int32),
    }


@pytest.mark.parametrize("rooted", [False, True], ids=["memory", "rooted"])
def test_spill_corrupt_block_dropped_not_served(tmp_path, rooted):
    spill = CacheSpillStore(4, root=str(tmp_path / "sp") if rooted else None)
    spill.events = _Events()
    spill.fault_injector = IoFaultInjector(seed=0, spill=1.0)
    spill.write("blk", _block())
    assert "blk" in spill
    assert spill.read("blk") is None
    assert spill.corrupt_drops == 1 and "blk" not in spill
    assert "spill_corrupt" in spill.events.kinds
    clean = CacheSpillStore(4, root=str(tmp_path / "cl") if rooted else None)
    clean.write("blk", _block())
    got = clean.read("blk")
    for k, v in _block().items():
        np.testing.assert_array_equal(got[k], v)


def test_spill_transient_read_fault_is_a_miss(tmp_path):
    spill = CacheSpillStore(4, root=str(tmp_path))
    spill.fault_injector = IoFaultInjector(seed=1, transient=1.0)
    spill.write("blk", _block())
    assert spill.read("blk") is None
    assert "blk" in spill
    spill.fault_injector = None
    assert spill.read("blk") is not None


def test_spill_checksums_and_files_match_reference(tmp_path):
    """A spilled block's checksum, row-dedup and stored size equal the
    reference's for the same content, and each package reads the other's
    rooted blocks."""
    rep = np.repeat(np.arange(12, dtype=np.int32).reshape(3, 4), 8, axis=0)
    arrays = {"multi_hot_ids": rep, "dense": np.linspace(0, 1, 24, dtype=np.float32)}
    ours = CacheSpillStore._dedup_rows(arrays)
    theirs = jstorage.CacheSpillStore._dedup_rows(arrays)
    assert sorted(ours) == sorted(theirs) and "multi_hot_ids__ddb" in ours
    np.testing.assert_array_equal(CacheSpillStore._checksum(ours),
                                  jstorage.CacheSpillStore._checksum(theirs))
    mine = CacheSpillStore(3, root=str(tmp_path))
    ref = jstorage.CacheSpillStore(3, root=str(tmp_path))
    assert mine.write("a-b-c", arrays) == ref.write("d-e-f", arrays)
    assert mine.owner_of("a-b-c") == ref.owner_of("a-b-c")
    for store, key in ((jstorage.CacheSpillStore(3, root=str(tmp_path)), "a-b-c"),
                       (CacheSpillStore(3, root=str(tmp_path)), "d-e-f")):
        back = store.read(key)
        for k, v in arrays.items():
            np.testing.assert_array_equal(back[k], v)


def test_warm_start_skips_garbage_npz(tmp_path):
    root = str(tmp_path)
    good, bad = "job-1-good", "job-0-bad"
    seeder = CacheSpillStore(4, root=root)
    seeder.write(good, _block())
    bad_dir = os.path.join(root, f"device{seeder.owner_of(bad):03d}")
    os.makedirs(bad_dir, exist_ok=True)
    with open(os.path.join(bad_dir, f"cache_{bad}.npz"), "wb") as f:
        f.write(b"this is not an npz archive")
    spill = CacheSpillStore(4, root=root)
    spill.events = _Events()
    assert len(spill) == 2
    cache = FeatureCache(1 << 30, spill=spill, device="cpu")
    assert cache.warm_start() == 1
    assert spill.corrupt_drops == 1 and bad not in spill
    assert "spill_corrupt" in spill.events.kinds


# -- simulated devices (test_devices.py, on the port) ----------------------------


def test_isp_device_ledger_and_occupancy():
    d = IspDevice(0, stream_bytes_per_s=1e6, compute_ops_per_s=1e6)
    assert d.charge_stream(500_000) == pytest.approx(0.5)
    assert d.busy_s == pytest.approx(0.5) and d.bytes_streamed == 500_000
    assert d.charge_compute(1_000_000) == pytest.approx(1.0)
    assert d.busy_s == pytest.approx(1.5) and d.compute_ops == 1e6
    d.charge_stream(100_000, spill=True)
    assert d.spill_bytes == 100_000 and d.bytes_streamed == 600_000
    assert d.spill_io_s == pytest.approx(0.1)
    assert d.busy_s == pytest.approx(1.6)
    d.enqueue(3)
    d.dequeue()
    assert d.queue_depth == 2
    d.begin_claim()
    d.begin_claim()
    assert d.inflight == 2 and d.max_inflight == 2
    d.end_claim()
    assert d.inflight == 1 and d.max_inflight == 2
    snap = d.snapshot()
    assert snap["device"] == 0 and snap["queue_depth"] == 2
    # the virtual-time reservation and the host slots match the reference
    jd = jstorage.IspDevice(0, stream_bytes_per_s=1e6, compute_ops_per_s=1e6)
    assert d.reserve(0.0, 2.0, nbytes=10) == (0.0, 2.0)
    assert jd.reserve(0.0, 2.0, nbytes=10) == (0.0, 2.0)
    assert d.reserve(1.0, 1.0) == jd.reserve(1.0, 1.0) == (2.0, 3.0)
    fleet, jfleet = DeviceFleet(2), jstorage.DeviceFleet(2)
    for now, s in ((0.0, 1.0), (0.5, 2.0), (0.2, 1.0)):
        assert fleet.reserve_host(now, s, parallelism=2) == jfleet.reserve_host(now, s, parallelism=2)
    assert fleet.makespan_s(2) == jfleet.makespan_s(2)


def test_partition_reads_charge_owning_device(rm1):
    src = rm1["src"]
    fleet = DeviceFleet(4)
    store = PartitionedStore(8, num_devices=4, source=src, fleet=fleet)
    part = store.read(5)
    assert fleet[1].bytes_streamed == part.nbytes()
    assert all(fleet[d].bytes_streamed == 0 for d in (0, 2, 3))
    assert fleet[1].busy_s > 0
    fleet2 = DeviceFleet(4)
    skewed = PartitionedStore(8, num_devices=4, source=src, fleet=fleet2, owner_map=[0] * 8)
    assert skewed.owner_of(5) == 0 and skewed.partitions_of(0) == list(range(8))
    assert skewed.partitions_of(1) == []
    part2 = skewed.read(5)
    assert fleet2[0].bytes_streamed == part2.nbytes()
    d1, d2 = decode_partition_numpy(part), decode_partition_numpy(part2)
    for col in d1["dense"]:
        np.testing.assert_array_equal(d1["dense"][col], d2["dense"][col])


@pytest.mark.parametrize("args", [(16, 4, 1.1, 0), (16, 4, 0.0, 0), (37, 5, 0.7, 3),
                                  (8, 8, 2.0, 9), (1, 3, 1.0, 1), (100, 7, 1.3, 42)])
def test_zipf_owner_map_equals_reference(args):
    assert zipf_owner_map(*args) == jstorage.zipf_owner_map(*args)


def test_zipf_owner_map_deterministic_and_skewed():
    m = zipf_owner_map(16, 4, alpha=1.1, seed=0)
    assert len(m) == 16 and set(m) <= set(range(4))
    assert m == zipf_owner_map(16, 4, alpha=1.1, seed=0)
    counts = [m.count(d) for d in range(4)]
    assert counts[0] == max(counts) and counts[0] >= 2 * min(counts)
    flat = zipf_owner_map(16, 4, alpha=0.0, seed=0)
    assert [flat.count(d) for d in range(4)] == [4, 4, 4, 4]


def _batch(pid: int, kb: int = 8):
    rng = np.random.default_rng(pid)
    return {
        "labels": rng.random(kb * 256).astype(np.float32),
        "dense": np.full((4,), pid, np.int32),
    }


def test_spill_promote_charges_owning_device():
    fleet = DeviceFleet(3)
    spill = CacheSpillStore(num_devices=3, fleet=fleet)
    cache = FeatureCache(capacity_bytes=2 * batch_nbytes(_batch(0)), spill=spill, device="cpu")
    keys = [CacheKey(f"part{i:04d}", "plan", "presto") for i in range(4)]
    for i, k in enumerate(keys):
        cache.put(k, _batch(i))
    assert cache.stats().evictions == 2
    owner = spill.owner_of(keys[0].block_id())
    io_before = spill.io_s_by_device[owner]
    block = cache.get(keys[0])
    assert block is not None
    np.testing.assert_array_equal(block["labels"].numpy(), _batch(0)["labels"])
    assert spill.io_s_by_device[owner] > io_before
    assert fleet[owner].spill_bytes > 0 and fleet[owner].busy_s > 0
    assert sum(spill.io_s_by_device) == pytest.approx(spill.modeled_io_s)
    st = cache.stats()
    assert st.spill_io_s_by_device and owner in st.spill_io_s_by_device


def test_contention_model_prices_queue_wait(rm1):
    model = ContentionAwareCostModel(queue_threshold=3)
    costs = partition_costs(rm1["spec"])
    assert costs.isp_s > 0 and costs.host_s > 0 and costs.link_bytes > 0
    assert model.contended_isp_s(costs.isp_s, 4) == pytest.approx(5 * costs.isp_s)
    assert not model.should_offload(costs, 0)
    assert not model.should_offload(costs, 2)
    q = 6
    expect = model.contended_isp_s(costs.isp_s, q) > costs.host_s
    assert model.should_offload(costs, q) == expect
    assert model.should_offload(None, 3) and not model.should_offload(None, 2)
