"""The port's CheckpointManager against the reference's, on the CPU.

At the reduced rm1 geometry (tables of 1,024 rows, the full MLP widths), a
2-step AdamW state: each package restores the other's checkpoint, every
leaf bitwise; for the same state the two write byte-identical
``MANIFEST.json`` and ``.npy`` files.  Tolerance: none, every comparison
is bitwise.  Then the port's own contract: the round trip, atomic rename and
GC of the reference's test, an async save that a later in-place step cannot
reach, a restore in place (no tensor reallocated) and chunked, and a shape
or dtype mismatch that raises naming the leaf.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_recsys as j_get_recsys
from repro.distributed.sharding import ShardingRules
from repro.models import recsys as JRS
from repro.train import CheckpointManager as JCheckpointManager
from repro.train import adamw as j_adamw
from repro.train import make_train_step as j_make_train_step
from repro.train import warmup_cosine as j_warmup_cosine
from repro.train.checkpoint import _leaf_path as j_leaf_path
from repro_torch.configs.registry import get_recsys
from repro_torch.core.presto import TorchPreStoEngine
from repro_torch.core.spec import TransformSpec
from repro_torch.data.storage import PartitionedStore
from repro_torch.data.synth import SyntheticRecSysSource
from repro_torch.models import recsys as RS
from repro_torch.train import (
    CheckpointManager,
    adamw,
    init_state,
    make_train_step,
    warmup_cosine,
)
from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train.checkpoint import flatten_state

ROWS = 128
LR = (1e-3, 2, 100)
RULES = ShardingRules.make(None)


@pytest.fixture(scope="module")
def two_step():
    """The reference's 2-step AdamW state and the port's, from the same
    initial weights and batches."""
    cfg, jcfg = get_recsys("rm1", reduced=True), j_get_recsys("rm1", reduced=True)
    src = SyntheticRecSysSource(cfg.data, rows=ROWS)
    engine = TorchPreStoEngine(TransformSpec.from_source(src), device="cpu")
    store = PartitionedStore(2, 1, src)
    batches = [engine.produce_batch(store, pid) for pid in range(2)]
    tree = jax.tree.map(np.asarray, JRS.init_params(jax.random.PRNGKey(0), jcfg))

    jopt = j_adamw(j_warmup_cosine(*LR))
    jstep = jax.jit(j_make_train_step(lambda p, b: JRS.loss_fn(p, b, jcfg, RULES), jopt))
    jstate = {"params": jax.tree.map(jnp.asarray, tree), "opt": jopt.init(tree),
              "step": jnp.zeros((), jnp.int32)}
    for mb in batches:
        jstate, _ = jstep(jstate, {k: jnp.asarray(v.numpy()) for k, v in mb.items()})

    opt = adamw(warmup_cosine(*LR))
    step = make_train_step(lambda m, b: RS.loss_fn(m, b, cfg), opt)
    state = init_state(RS.params_from_numpy(tree, cfg, "cpu"), opt)
    for mb in batches:
        state, _ = step(state, mb)
    return {"cfg": cfg, "tree": tree, "jstate": jstate, "state": state, "opt": opt,
            "step": step, "batch": batches[0]}


def fresh_state(s, seed=7):
    """A port state of the right structure whose values differ from both
    2-step states."""
    return init_state(RS.init_params(torch.Generator().manual_seed(seed), s["cfg"], "cpu"),
                      s["opt"])


def leaves(state) -> dict:
    return {name: t.detach().numpy().copy() for name, t in flatten_state(state)}


def j_leaves(jstate) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(jstate)[0]
    return {j_leaf_path(p): np.asarray(v) for p, v in flat}


def assert_same_leaves(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for name, w in want.items():
        assert got[name].dtype == w.dtype and got[name].shape == w.shape, name
        np.testing.assert_array_equal(got[name], w, err_msg=name)


def port_of(jstate, cfg):
    """The reference's state as a port state: params through
    ``params_from_numpy``, the moments by the port's parameter names."""
    def by_name(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update({f"{k}.{kk}": torch.from_numpy(np.array(vv)) for kk, vv in v.items()})
            else:
                out[k] = torch.from_numpy(np.array(v))
        return out

    host = jax.tree.map(np.asarray, jstate)
    return {"params": RS.params_from_numpy(host["params"], cfg, "cpu"),
            "opt": {"m": by_name(host["opt"]["m"]), "v": by_name(host["opt"]["v"]),
                    "count": torch.from_numpy(np.array(host["opt"]["count"]))},
            "step": torch.from_numpy(np.array(host["step"]))}


def test_leaf_paths_and_order_are_the_reference_s(two_step):
    names = [n for n, _ in flatten_state(two_step["state"])]
    assert names == list(j_leaves(two_step["jstate"]))
    assert names[0] == "opt/count" and names[-1] == "step"
    assert "params/bottom/w0" in names and "opt/m/tables" in names


def test_reference_checkpoint_restores_bitwise_in_the_port(two_step, tmp_path):
    JCheckpointManager(str(tmp_path), async_save=False).save(2, two_step["jstate"])
    target = fresh_state(two_step)
    out = CheckpointManager(str(tmp_path)).restore(target=target)
    assert out is target
    assert_same_leaves(leaves(out), j_leaves(two_step["jstate"]))


def test_port_checkpoint_restores_bitwise_in_the_reference(two_step, tmp_path):
    CheckpointManager(str(tmp_path), async_save=False).save(2, two_step["state"])
    jtarget = jax.tree.map(jnp.zeros_like, two_step["jstate"])
    restored = JCheckpointManager(str(tmp_path)).restore(target=jtarget)
    assert_same_leaves(j_leaves(restored), leaves(two_step["state"]))


def test_same_state_writes_byte_identical_files(two_step, tmp_path):
    """The reference's 2-step state, crossed over to the port: both
    packages' files are equal byte for byte."""
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    JCheckpointManager(str(jdir), async_save=False).save(2, two_step["jstate"])
    CheckpointManager(str(tdir), async_save=False).save(
        2, port_of(two_step["jstate"], two_step["cfg"]))
    jfiles = sorted(os.listdir(jdir / "step_000000002"))
    assert jfiles == sorted(os.listdir(tdir / "step_000000002"))
    assert "MANIFEST.json" in jfiles and len(jfiles) == len(j_leaves(two_step["jstate"])) + 1
    for fn in jfiles:
        a = (jdir / "step_000000002" / fn).read_bytes()
        b = (tdir / "step_000000002" / fn).read_bytes()
        assert a == b, fn


def test_roundtrip_atomic_and_gc(two_step, tmp_path):
    """Mirror of tests/test_train.py::test_checkpoint_roundtrip_atomic_and_gc."""
    d = str(tmp_path)
    state = two_step["state"]
    ck = CheckpointManager(d, keep=2, async_save=False)
    for s in (1, 2, 3):
        ck.save(s, state)
    assert ck.latest_step() == 3
    # keep=2 garbage-collects step 1
    assert not os.path.exists(os.path.join(d, "step_000000001"))
    assert not [p for p in os.listdir(d) if p.endswith(".tmp")]  # renamed, committed
    restored = ck.restore(target=fresh_state(two_step))
    assert_same_leaves(leaves(restored), leaves(state))
    # a stale .tmp dir is cleaned up on next manager start
    os.makedirs(os.path.join(d, "step_000000009.tmp"))
    CheckpointManager(d)
    assert not os.path.exists(os.path.join(d, "step_000000009.tmp"))
    # a directory without a manifest is no checkpoint
    os.makedirs(os.path.join(d, "step_000000010"))
    assert ck.latest_step() == 3


def test_async_save_holds_the_pre_step_values(two_step, tmp_path):
    """The port's step updates params and moments in place: a save still
    writing when the next step runs must hold the values of its own step."""
    s = two_step
    state = init_state(RS.params_from_numpy(s["tree"], s["cfg"], "cpu"), s["opt"])
    state, _ = s["step"](state, s["batch"])
    before = leaves(state)
    ck = CheckpointManager(str(tmp_path), async_save=True)
    ck.save(1, state)
    state, _ = s["step"](state, s["batch"])  # in place, while the writer runs
    ck.wait()
    assert not np.array_equal(leaves(state)["params/tables"], before["params/tables"])
    assert_same_leaves(leaves(ck.restore(1, target=fresh_state(s))), before)
    assert ck.last_save["step"] == 1 and ck.last_save["write_s"] is not None
    assert ck.last_save["bytes"] == sum(a.nbytes for a in before.values())


def test_restore_fills_the_target_in_place(two_step, tmp_path):
    """No leaf is reallocated: every tensor keeps its storage."""
    ck = CheckpointManager(str(tmp_path), async_save=False)
    ck.save(2, two_step["state"])
    target = fresh_state(two_step)
    ptrs = [t.data_ptr() for _, t in flatten_state(target)]
    ck.restore(2, target=target)
    assert [t.data_ptr() for _, t in flatten_state(target)] == ptrs
    assert_same_leaves(leaves(target), leaves(two_step["state"]))


def test_restore_copies_in_chunks(two_step, tmp_path, monkeypatch):
    """With a chunk of a few rows every large leaf is copied in many chunks,
    none larger than the chunk, and the restore is still bitwise."""
    ck = CheckpointManager(str(tmp_path), async_save=False)
    ck.save(2, two_step["state"])
    monkeypatch.setattr(ckpt_mod, "CHUNK_BYTES", 4096)
    sizes = []
    real = ckpt_mod.leaf_chunks

    def spy(arr, dst):
        for src, out in real(arr, dst):
            sizes.append(src.nbytes)
            yield src, out

    monkeypatch.setattr(ckpt_mod, "leaf_chunks", spy)
    target = ck.restore(2, target=fresh_state(two_step))
    assert_same_leaves(leaves(target), leaves(two_step["state"]))
    tables = two_step["state"]["params"].tables
    assert len(sizes) > 3 * tables.numel() * 4 // 4096
    assert max(sizes) <= 4096


@pytest.mark.parametrize("what", ["shape", "dtype"])
def test_mismatched_leaf_raises_naming_it(two_step, tmp_path, what):
    ck = CheckpointManager(str(tmp_path), async_save=False)
    ck.save(2, two_step["state"])
    target = fresh_state(two_step)
    w = target["params"].top["w0"]
    if what == "shape":
        target["params"].top["w0"] = torch.nn.Parameter(torch.zeros(w.shape[0] + 1, w.shape[1]))
    else:
        target["params"].top["w0"] = torch.nn.Parameter(torch.zeros(w.shape, dtype=torch.float64))
    with pytest.raises(ValueError, match="opt/m/top/w0|params/top/w0"):
        ck.restore(2, target=target)
