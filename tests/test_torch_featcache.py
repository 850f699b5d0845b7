"""The port's feature cache and the engine's block-cache surface.

A hit is bitwise the cold compute it replaces.  The memory tier holds
batches as produced (tensors on the engine's device) and counts each
tensor's ``numel() * element_size()``; a batch crosses to the host once,
when it spills, and comes back to the cache's device when a spill hit is
promoted.  ``assemble_from_blocks`` rebuilds a dedup partition's batch from
cached blocks and the rest program: bitwise a cold produce of the port, and
equal to the reference's assembly (integers and labels bitwise, ``dense`` to
rtol=atol=1e-6, since log1p may differ by 1 ulp between the libraries).
"""

import dataclasses
import os
import threading

import numpy as np
import pytest
import torch

from repro.core.featcache import BlockKey as JBlockKey
from repro.core.featcache import FeatureCache as JFeatureCache
from repro.core.featcache import batch_nbytes as j_batch_nbytes
from repro.core.presto import PreStoEngine
from repro.core.spec import TransformSpec as JSpec
from repro.data.storage import PartitionedStore as JStore
from repro.data.synth import RM_CONFIGS as J_RM_CONFIGS
from repro.data.synth import SyntheticRecSysSource as JSource
from repro_torch.configs.registry import get_recsys
from repro_torch.core.featcache import (
    BlockKey,
    CacheKey,
    FeatureCache,
    batch_nbytes,
    default_spill_store,
)
from repro_torch.core.presto import TorchPreStoEngine
from repro_torch.core.spec import TransformSpec
from repro_torch.data.storage import CacheSpillStore, PartitionedStore
from repro_torch.data.synth import RM_CONFIGS, SyntheticRecSysSource

DENSE_TOL = dict(rtol=1e-6, atol=1e-6, equal_nan=True)


@pytest.fixture(scope="module")
def rm1():
    rcfg = get_recsys("rm1", reduced=True)
    src = SyntheticRecSysSource(rcfg.data, rows=128)
    spec = TransformSpec.from_source(src)
    store = PartitionedStore(12, num_devices=4, source=src)
    engine = TorchPreStoEngine(spec, device="cpu")
    return rcfg, src, spec, store, engine


@pytest.fixture(scope="module")
def dedup4():
    """rm2 at full width, 128 rows, one shared block per 4 rows (seed 3)."""
    cfg = dataclasses.replace(RM_CONFIGS["rm2"], rows_per_partition=128, dup_factor=4)
    jcfg = dataclasses.replace(J_RM_CONFIGS["rm2"], rows_per_partition=128, dup_factor=4)
    src, jsrc = SyntheticRecSysSource(cfg, seed=3), JSource(jcfg, seed=3)
    return {"src": src, "jsrc": jsrc, "spec": TransformSpec.from_source(src),
            "jspec": JSpec.from_source(jsrc), "store": PartitionedStore(3, 2, src),
            "jstore": JStore(3, 2, jsrc)}


def _batch(pid: int, kb: int = 8):
    rng = np.random.default_rng(pid)
    return {
        "labels": rng.random(kb * 256).astype(np.float32),  # kb KiB
        "dense": np.full((4,), pid, np.int32),
    }


def _key(i: int, plan: str = "plan", placement: str = "presto") -> CacheKey:
    return CacheKey(f"part{i:04d}", plan, placement)


def _equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(torch.as_tensor(np.asarray(a[k])), torch.as_tensor(np.asarray(b[k]))), k


# -- content addressing ---------------------------------------------------------


def test_structural_hash_survives_relowering(rm1):
    rcfg, src, spec, store, engine = rm1
    h1 = engine.lowered_plan.structural_hash()
    spec2 = TransformSpec.from_source(SyntheticRecSysSource(rcfg.data, rows=128))
    assert TorchPreStoEngine(spec2, device="cpu").lowered_plan.structural_hash() == h1
    unfused = TorchPreStoEngine(spec2, kernel_mode="unfused", device="cpu")
    assert unfused.lowered_plan.structural_hash() != h1
    assert TorchPreStoEngine(spec2, device="cpu").cache_signature() == engine.cache_signature()
    disagg = TorchPreStoEngine(spec2, placement="disagg", device="cpu")
    assert disagg.cache_signature() != engine.cache_signature()


def test_cache_keys_never_cross_packages(rm1):
    """C2: the port's signature carries its backend tag, so a batch the
    reference cached is never a hit for the port, even for equal content
    and an equal lowered plan."""
    rcfg, src, spec, store, engine = rm1
    from repro.data.synth import SyntheticRecSysSource as JS
    from repro.configs.registry import get_recsys as jget

    jengine = PreStoEngine(JSpec.from_source(JS(jget("rm1", reduced=True).data, rows=128)))
    assert jengine.lowered_plan.structural_hash() == engine.lowered_plan.structural_hash()
    assert jengine.cache_signature() != engine.cache_signature()
    jstore = JStore(12, 4, JS(jget("rm1", reduced=True).data, rows=128))
    assert jstore.partition_fingerprint(3) == store.partition_fingerprint(3)
    cache = FeatureCache(1 << 20, device="cpu")
    cache.put(CacheKey(jstore.partition_fingerprint(3), jengine.cache_signature(), "presto"),
              _batch(3))
    assert cache.get(CacheKey(store.partition_fingerprint(3), engine.cache_signature(),
                              "presto")) is None


def test_partition_fingerprint_content_addressed(rm1):
    rcfg, src, spec, store, engine = rm1
    store2 = PartitionedStore(12, num_devices=2,
                              source=SyntheticRecSysSource(rcfg.data, rows=128))
    assert store.partition_fingerprint(3) == store2.partition_fingerprint(3)
    assert store.partition_fingerprint(3) != store.partition_fingerprint(4)
    store3 = PartitionedStore(12, num_devices=4,
                              source=SyntheticRecSysSource(rcfg.data, rows=64))
    assert store.partition_fingerprint(3) != store3.partition_fingerprint(3)


def test_disk_backed_fingerprint_hashes_file_bytes(rm1, tmp_path):
    rcfg, src, spec, store, engine = rm1
    d1, d2 = tmp_path / "a", tmp_path / "b"
    s1 = PartitionedStore(4, num_devices=2, source=src, root=str(d1))
    s2 = PartitionedStore(4, num_devices=2, source=src, root=str(d2))
    assert s1.partition_fingerprint(2) == store.partition_fingerprint(2)
    s1.materialize([0, 1])
    s2.materialize([0, 1])
    fp0 = s1.partition_fingerprint(0)
    assert fp0 == s2.partition_fingerprint(0)
    assert fp0 != s1.partition_fingerprint(1)
    p1 = PartitionedStore(4, num_devices=2, root=str(d1))
    assert p1.partition_fingerprint(0) == fp0
    path = p1._path(0)
    with open(path, "ab") as f:
        f.write(b"\0" * 8)
    os.utime(path, ns=(1, 1))
    assert p1.partition_fingerprint(0) != fp0
    assert s1.partition_fingerprint(0) != fp0


# -- the cache proper -------------------------------------------------------------


def test_hit_is_bitwise_identical_to_cold_compute(rm1):
    rcfg, src, spec, store, engine = rm1
    cold = engine.produce_batch(store, 0)
    cache = FeatureCache(64 << 20, device="cpu")
    key = CacheKey(store.partition_fingerprint(0), engine.cache_signature(), engine.placement)
    assert cache.get(key) is None
    cache.put(key, cold)
    hit = cache.get(key)
    _equal(cold, hit)
    assert all(hit[k] is cold[k] for k in cold)  # the memory tier never copies
    st = cache.stats()
    assert st.hits == 1 and st.misses == 1 and st.insertions == 1


def test_cache_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FeatureCache(1 << 20)
    assert FeatureCache(1 << 20, device="cpu").device.type == "cpu"


def test_lru_eviction_under_memory_bound():
    one = batch_nbytes(_batch(0))
    cache = FeatureCache(capacity_bytes=3 * one, device="cpu")
    for i in range(5):
        cache.put(_key(i), _batch(i))
    st = cache.stats()
    assert st.evictions == 2 and st.entries == 3
    assert st.resident_bytes <= cache.capacity_bytes
    assert cache.get(_key(0)) is None and cache.get(_key(1)) is None
    assert all(cache.get(_key(i)) is not None for i in (2, 3, 4))
    cache.get(_key(2))
    cache.put(_key(5), _batch(5))
    assert cache.get(_key(3)) is None and cache.get(_key(2)) is not None


def test_device_batches_counted_by_elements_and_evicted_at_the_bound(rm1):
    """A batch of tensors the host cannot read (meta tensors stand in for a
    card here) is sized by numel * element_size, never 0, and the memory
    tier evicts at its bound."""
    rcfg, src, spec, store, engine = rm1
    cold = engine.produce_batch(store, 0)
    want = sum(v.numel() * v.element_size() for v in cold.values())
    assert batch_nbytes(cold) == want == sum(np.asarray(v).nbytes for v in cold.values())
    meta = {k: torch.empty_like(v, device="meta") for k, v in cold.items()}
    assert j_batch_nbytes(meta) == 0  # the reference's literal copy fails
    assert batch_nbytes(meta) == want
    cache = FeatureCache(capacity_bytes=2 * want, device="cpu")
    for i in range(5):
        cache.put(_key(i), meta)
    st = cache.stats()
    assert st.entries == 2 and st.evictions == 3 and st.resident_bytes == 2 * want
    assert batch_nbytes(object()) == 0  # not a batch: uncacheable


def test_eviction_spills_and_spill_hit_promotes():
    spill = CacheSpillStore(num_devices=3, bytes_per_s=1e6)
    cache = FeatureCache(capacity_bytes=2 * batch_nbytes(_batch(0)), spill=spill, device="cpu")
    for i in range(4):
        cache.put(_key(i), _batch(i))
    assert cache.stats().evictions == 2
    assert len(spill) == 2 and spill.bytes_written > 0
    io0 = spill.modeled_io_s
    block = cache.get(_key(0))
    assert isinstance(block["labels"], torch.Tensor) and block["labels"].device.type == "cpu"
    np.testing.assert_array_equal(block["labels"].numpy(), _batch(0)["labels"])
    st = cache.stats()
    assert st.spill_hits == 1 and spill.bytes_read > 0
    assert spill.modeled_io_s > io0
    hits0 = st.hits
    assert cache.get(_key(0)) is not None
    assert cache.stats().spill_hits == 1 and cache.stats().hits == hits0 + 1


def test_spilled_tensor_batches_come_back_bitwise(rm1):
    """Produced batches (tensors) spill through the host and promote back as
    tensors on the cache's device, bitwise the cold batches."""
    rcfg, src, spec, store, engine = rm1
    cold = {pid: engine.produce_batch(store, pid) for pid in range(4)}
    spill = default_spill_store(2)
    cache = FeatureCache(capacity_bytes=2 * batch_nbytes(cold[0]), spill=spill, device="cpu")
    keys = {pid: CacheKey(store.partition_fingerprint(pid), engine.cache_signature(),
                          engine.placement) for pid in cold}
    for pid in cold:
        cache.put(keys[pid], cold[pid])
    assert len(spill) == 2
    for pid in cold:
        _equal(cache.get(keys[pid]), cold[pid])
    st = cache.stats()  # promoting 0 and 1 evicted 2 and 3 to the spill tier
    assert st.spill_hits == 4 and st.hits == 4 and st.entries == 2


def test_spill_store_disk_roundtrip(tmp_path):
    spill = CacheSpillStore(num_devices=2, root=str(tmp_path))
    arrays = {"a": np.arange(7, dtype=np.float32), "b": np.eye(3, dtype=np.int32)}
    n = spill.write("blk", arrays)
    assert n == arrays["a"].nbytes + arrays["b"].nbytes
    back = spill.read("blk")
    np.testing.assert_array_equal(back["a"], arrays["a"])
    np.testing.assert_array_equal(back["b"], arrays["b"])
    assert spill.read("missing") is None


def test_inflight_begin_follow_fulfill():
    cache = FeatureCache(1 << 20, device="cpu")
    status, val = cache.begin(_key(0))
    assert status == "produce" and val is None
    status, fut = cache.begin(_key(0))
    assert status == "follow" and not fut.done()
    cache.fulfill(_key(0), _batch(0))
    np.testing.assert_array_equal(fut.result(timeout=1)["labels"], _batch(0)["labels"])
    assert cache.begin(_key(0))[0] == "hit"
    assert cache.begin(_key(1))[0] == "produce"
    _, fut2 = cache.begin(_key(1))
    cache.abandon(_key(1), RuntimeError("device on fire"))
    with pytest.raises(RuntimeError, match="on fire"):
        fut2.result(timeout=1)


def test_concurrent_probes_produce_each_key_once(rm1):
    """Threads racing the same cold keys: one leader produces each key, the
    rest hit or follow, and every thread sees the cold batch."""
    rcfg, src, spec, store, engine = rm1
    cache = FeatureCache(256 << 20, device="cpu")
    produced, outs = [], {t: {} for t in range(4)}

    def tenant(t):
        for pid in range(6):
            key = CacheKey(store.partition_fingerprint(pid), engine.cache_signature(), "presto")
            status, val = cache.begin(key)
            if status == "produce":
                produced.append(pid)
                val = engine.produce_batch(store, pid)
                cache.fulfill(key, val)
            elif status == "follow":
                val = val.result(timeout=30)
            outs[t][pid] = val

    threads = [threading.Thread(target=tenant, args=(t,)) for t in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads)
    assert sorted(produced) == list(range(6))
    cs = cache.stats()
    assert cs.misses == 6 and cs.hits + cs.follows == 18
    for t in range(1, 4):
        for pid in range(6):
            _equal(outs[t][pid], outs[0][pid])


# -- restart survival ---------------------------------------------------------------


def test_spill_store_rescans_blocks_after_restart(tmp_path):
    spill = CacheSpillStore(num_devices=2, root=str(tmp_path))
    arrays = {"a": np.arange(9, dtype=np.float32)}
    spill.write("blk1", arrays)
    spill.write("blk2", {"a": np.ones(4, np.int32)})
    reborn = CacheSpillStore(num_devices=2, root=str(tmp_path))
    assert set(reborn.keys()) == {"blk1", "blk2"}
    assert "blk1" in reborn and reborn.resident_bytes > 0
    io0 = reborn.io_s_by_device[reborn.owner_of("blk1")]
    back = reborn.read("blk1")
    np.testing.assert_array_equal(back["a"], arrays["a"])
    assert reborn.io_s_by_device[reborn.owner_of("blk1")] > io0


def test_flush_then_warm_start_serves_bitwise_hits(rm1, tmp_path):
    """A cache flushed to a rooted spill tier and rebuilt over the same root
    serves every batch bitwise, with no produce."""
    rcfg, src, spec, store, engine = rm1
    cold = {pid: engine.produce_batch(store, pid) for pid in range(4)}
    keys = {pid: CacheKey(store.partition_fingerprint(pid), engine.cache_signature(),
                          engine.placement) for pid in cold}
    capacity = 3 * batch_nbytes(cold[0])
    first = FeatureCache(capacity, spill=CacheSpillStore(2, root=str(tmp_path)), device="cpu")
    for pid in cold:
        first.put(keys[pid], cold[pid])
    assert first.flush_spill() >= 3
    second = FeatureCache(capacity, spill=CacheSpillStore(2, root=str(tmp_path)), device="cpu")
    assert second.warm_start() == 3
    assert second.warm_start() == 0  # idempotent
    for pid in cold:
        _equal(second.get(keys[pid]), cold[pid])
    assert second.stats().hits == 4 and second.stats().misses == 0


# -- predictive pre-warm -------------------------------------------------------------


def test_prewarm_probe_counts_apart_from_claim_path():
    cache = FeatureCache(1 << 20, device="cpu")
    cache.put(_key(0), _batch(0))
    status, batch = cache.begin(_key(0), prewarm=True)
    assert status == "hit"
    np.testing.assert_array_equal(batch["labels"], _batch(0)["labels"])
    cs = cache.stats()
    assert cs.prewarm_hits == 1 and cs.hits == 0 and cs.misses == 0
    status, val = cache.begin(_key(1), prewarm=True)
    assert status == "produce" and val is None
    cs = cache.stats()
    assert cs.prewarm_leases == 1 and cs.misses == 0
    status, fut = cache.begin(_key(1))
    assert status == "follow"
    cache.fulfill(_key(1), _batch(1))
    np.testing.assert_array_equal(fut.result(timeout=1)["labels"], _batch(1)["labels"])
    assert cache.stats().follows == 1
    assert cache.begin(_key(0))[0] == "hit"
    assert cache.stats().hits == 1


def test_prewarm_spill_hit_promotes_without_hit_accounting():
    spill = CacheSpillStore(num_devices=2, bytes_per_s=1e6)
    cache = FeatureCache(capacity_bytes=2 * batch_nbytes(_batch(0)), spill=spill, device="cpu")
    for i in range(4):
        cache.put(_key(i), _batch(i))
    status, block = cache.begin(_key(0), prewarm=True)
    assert status == "hit"
    np.testing.assert_array_equal(block["labels"].numpy(), _batch(0)["labels"])
    cs = cache.stats()
    assert cs.prewarm_hits == 1 and cs.hits == 0 and cs.spill_hits == 0
    assert cache.begin(_key(0))[0] == "hit"
    cs = cache.stats()
    assert cs.hits == 1 and cs.spill_hits == 0


# -- block tier and assembly ------------------------------------------------------------


def test_block_tier_all_or_nothing_and_bounded():
    cache = FeatureCache(1 << 20, block_capacity_bytes=3 * (2 * 8 * 4 + 2 * 4), device="cpu")
    ids = [np.full((2, 8), b, np.int32) for b in range(5)]
    lens = [np.full((2,), b, np.int32) for b in range(5)]
    keys = [BlockKey(f"b{b}", "plan", "presto") for b in range(5)]
    for k, i, l in zip(keys[:2], ids, lens):
        cache.put_block(k, torch.from_numpy(i), l)  # tensors cross to the host
    assert cache.get_blocks(keys[:3]) is None  # one absent: nothing
    got_ids, got_lens = cache.get_blocks(keys[:2])
    np.testing.assert_array_equal(got_ids, np.stack(ids[:2]))
    np.testing.assert_array_equal(got_lens, np.stack(lens[:2]))
    for k, i, l in zip(keys[2:], ids[2:], lens[2:]):
        cache.put_block(k, i, l)
    st = cache.stats()
    assert st.block_entries == 3 and st.block_resident_bytes <= cache.block_capacity_bytes
    assert cache.get_block(keys[0]) is None and cache.get_block(keys[4]) is not None


def _publish_and_assemble(engine, store, cache, pid, cold):
    refs = store.block_refs(pid)
    keys = [BlockKey(fp, engine.cache_signature(), engine.placement)
            for fp in store.block_fingerprints(pid)]
    ids, lens = engine.extract_blocks(cold, refs)
    for k, i, l in zip(keys, ids, lens):
        cache.put_block(k, i, l)
    block_ids, block_lens = cache.get_blocks(keys)
    return engine.assemble_from_blocks(engine.stage_partition(store, pid), block_ids, block_lens)


@pytest.mark.parametrize("placement,kernel_mode", [("presto", None), ("disagg", "unfused")])
def test_assemble_from_blocks_is_a_cold_produce(dedup4, placement, kernel_mode):
    """The assembled batch is bitwise the port's cold produce; under presto
    the rest program runs fused_dense and fused_gen and no sparse kernel."""
    engine = TorchPreStoEngine(dedup4["spec"], placement=placement, kernel_mode=kernel_mode,
                               device="cpu")
    cache = FeatureCache(64 << 20, device="cpu")
    for pid in range(3):
        cold = engine.produce_batch(dedup4["store"], pid)
        ids, lens = engine.extract_blocks(cold, dedup4["store"].block_refs(pid))
        assert ids.shape == (32, 42, 32) and lens.shape == (32, 42)
        assert isinstance(ids, np.ndarray) and ids.dtype == np.int32
        got = _publish_and_assemble(engine, dedup4["store"], cache, pid, cold)
        _equal(got, cold)
    stats = cache.stats()
    assert stats.block_hits == 3 * 32 and stats.block_misses == 0
    rest = [st.name for st in engine.lowered_plan.stages
            if st.family not in ("sparse", "lengths") and st.name != "form_batch"]
    if placement == "presto":
        assert rest == ["fused_dense", "fused_gen", "decode_labels"]
    else:
        assert not any(name.startswith("fused") or "sparse" in name for name in rest)


def test_assemble_from_blocks_matches_reference(dedup4):
    """The port's assembly equals the reference's on the same partition and
    blocks: integers and labels bitwise, dense to the stated tolerance."""
    jengine = PreStoEngine(dedup4["jspec"], interpret=True)
    engine = TorchPreStoEngine(dedup4["spec"], device="cpu")
    jcache, cache = JFeatureCache(64 << 20), FeatureCache(64 << 20, device="cpu")
    pid = 1
    jcold = jengine.produce_batch(dedup4["jstore"], pid)
    jrefs = dedup4["jstore"].block_refs(pid)
    jkeys = [JBlockKey(fp, jengine.cache_signature(), "presto")
             for fp in dedup4["jstore"].block_fingerprints(pid)]
    jids, jlens = jengine.extract_blocks(jcold, jrefs)
    for k, i, l in zip(jkeys, jids, jlens):
        jcache.put_block(k, i, l)
    want = jengine.assemble_from_blocks(jengine.stage_partition(dedup4["jstore"], pid),
                                        *jcache.get_blocks(jkeys))
    cold = engine.produce_batch(dedup4["store"], pid)
    ids, lens = engine.extract_blocks(cold, dedup4["store"].block_refs(pid))
    np.testing.assert_array_equal(ids, np.asarray(jids))
    np.testing.assert_array_equal(lens, np.asarray(jlens))
    got = _publish_and_assemble(engine, dedup4["store"], cache, pid, cold)
    assert sorted(got) == sorted(want)
    for key in want:
        w, g = np.asarray(want[key]), got[key].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, key
        if key == "dense":
            np.testing.assert_allclose(g, w, **DENSE_TOL)
        else:
            np.testing.assert_array_equal(g, w, err_msg=key)


def test_assemble_refuses_refs_beyond_the_blocks(dedup4):
    engine = TorchPreStoEngine(dedup4["spec"], device="cpu")
    pages = engine.stage_partition(dedup4["store"], 0)
    ids = np.zeros((31, 42, 32), np.int32)  # one block short of the refs
    with pytest.raises(ValueError, match="refs outside"):
        engine.assemble_from_blocks(pages, ids, np.zeros((31, 42), np.int32))
