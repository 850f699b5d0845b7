"""Checkpoints of sharded state and the meshed ElasticTrainer, on CPU ranks
over gloo, against the JAX package's CheckpointManager and the port's
one-device runs, at the reduced rm2 geometry.

Each world is a ``launch.mesh.run_spmd`` call running a rank program of
``torch_mesh_elastic_ranks.py``; module-scoped fixtures run each world
once for the tests that read it.  The global state is seeded numpy: the
reference's initial DLRM params perturbed, random AdamW moments, count
and step 3.  Tolerances, and why:

* the files of a 2-rank (1, 2) and a 4-rank (2, 2) meshed save are
  byte-identical to the reference's save of the global state (the 4-rank
  world moves and reads its blocks in chunks of 4,096 bytes); the
  reference restores the meshed save bitwise; the reference's checkpoint
  restores into the ranks' blocks bitwise: every comparison is of bytes;
* the elastic drill (checkpoints every 2 steps, a failure at step 3 on
  (1, 2), a resume on (1, 2), on (1, 4) and on one device) against
  straight runs, in f64: every resume and every straight run agree within
  1e-6 (bitwise when written), on one mesh and across topologies;
* the same drill in f32, the model's dtype: losses within 1e-6
  everywhere; parameters within 1e-6 where every step ran on one mesh
  (the (1, 2) resume against the straight (1, 2) run) and within 1e-5,
  the reference elastic test's bound, where the history crossed
  topologies (the first two steps ran on (1, 2)).  A mesh pools the bag
  in another order, and AdamW's update, which divides each gradient entry
  by its own scale, turns the last-bit differences of small entries into
  differences of a fraction of lr: straight (1, 2) and one-device runs,
  with no restart at all, differ by up to 3.6e-6 after 4 steps at lr 1e-3
  (``test_straight_runs_differ_across_topologies_as_much``).  Since the
  f64 drill agrees bitwise, that distance is f32 rounding, not the meshed
  step or the restart.
"""

import functools
import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_elastic_ranks as R
from repro.configs.registry import get_recsys as j_get_recsys
from repro.models import recsys as JRS
from repro.train import CheckpointManager as JCheckpointManager
from repro_torch.core.presto import TorchPreStoEngine
from repro_torch.core.spec import TransformSpec
from repro_torch.data.storage import PartitionedStore
from repro_torch.data.synth import SyntheticRecSysSource
from repro_torch.distributed.sharding import shard
from repro_torch.launch.mesh import Mesh, World
from repro_torch.train import CheckpointManager, ElasticTrainer
from repro_torch.train.checkpoint import flatten_state

STEP = 3  # the seeded global state's step
TOL = 1e-6  # losses; parameters of runs on one mesh throughout
CROSS_TOL = 1e-5  # parameters of histories across topologies (the reference elastic test's bound)
ROWS = 64  # rows of each global batch
STEPS, FAIL_AT, EVERY = 4, 3, 2
SAVE_WORLDS = {2: ((1, 2), 1 << 28), 4: ((2, 2), 4096)}  # ranks -> (mesh, chunk bytes)
FAILED_MESH = (1, 2)  # the mesh of the incarnation that fails
RESUMES = {"(1, 2)": (1, 2), "(1, 4)": (1, 4), "one device": None}
AXES = ("data", "model")


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(tree[k], path) if isinstance(tree[k], dict) else {path: tree[k]})
    return out


@pytest.fixture(scope="module")
def seeded(tmp_path_factory):
    """The reference's checkpoint of the seeded global state, its leaves by
    path, and the initial params as an ``.npz`` for the ranks."""
    root = tmp_path_factory.mktemp("mesh_elastic")
    init = jax.tree.map(np.asarray, JRS.init_params(jax.random.PRNGKey(0),
                                                     j_get_recsys("rm2", reduced=True)))
    tree_path = root / "init.npz"
    np.savez(tree_path, **_flat(init))
    rng = np.random.default_rng(3)
    noise = lambda a: (a + rng.standard_normal(a.shape)).astype(np.float32)  # noqa: E731
    state = {"params": jax.tree.map(noise, init),
             "opt": {"m": jax.tree.map(noise, init),
                     "v": jax.tree.map(lambda a: np.abs(noise(a)), init),
                     "count": np.int32(STEP)},
             "step": np.int32(STEP)}
    ref = root / "reference"
    JCheckpointManager(str(ref), async_save=False).save(STEP, jax.tree.map(jnp.asarray, state))
    return {"root": root, "tree": str(tree_path), "ref": ref, "state": state,
            "leaves": _flat(state)}


@pytest.fixture(scope="module")
def save_worlds(seeded):
    """Per world size: each rank's restored blocks, coords and specs, and
    the directory of its meshed save."""
    out = {}
    for n, (shape, chunk) in SAVE_WORLDS.items():
        d = seeded["root"] / f"meshed-{n}"
        ranks = World(shape, AXES, "cpu").run(
            R.save_restore_rank, args=(seeded["tree"], str(seeded["ref"]), str(d), STEP, chunk),
            timeout=300)
        out[n] = {"dir": d, "ranks": ranks, "shape": shape}
    return out


def _step_files(d: Path) -> dict:
    sd = d / f"step_{STEP:09d}"
    return {p.name: p.read_bytes() for p in sorted(sd.iterdir())}


@pytest.mark.parametrize("n", sorted(SAVE_WORLDS))
def test_meshed_save_is_the_reference_bytes(seeded, save_worlds, n):
    got, want = _step_files(save_worlds[n]["dir"]), _step_files(seeded["ref"])
    assert sorted(got) == sorted(want) and "MANIFEST.json" in got
    assert [name for name in want if got[name] != want[name]] == []
    # every rank saw the commit once save returned
    assert [r["latest"] for r in save_worlds[n]["ranks"]] == [STEP] * n


@pytest.mark.parametrize("n", sorted(SAVE_WORLDS))
def test_reference_restores_the_meshed_save(seeded, save_worlds, n):
    target = jax.tree.map(jnp.asarray, seeded["state"])
    got = _flat(jax.tree.map(np.asarray, JCheckpointManager(str(save_worlds[n]["dir"])).restore(
        STEP, target=target)))
    for path, want in seeded["leaves"].items():
        assert got[path].dtype == np.asarray(want).dtype
        assert np.array_equal(got[path], want), path


@pytest.mark.parametrize("n", sorted(SAVE_WORLDS))
def test_reference_checkpoint_restores_into_blocks(seeded, save_worlds, n):
    world = save_worlds[n]
    sharded = 0
    for rank, r in enumerate(world["ranks"]):
        view = Mesh(dict(zip(AXES, world["shape"])), rank, torch.device("cpu"), "gloo")
        assert r["coords"] == view.coords
        for path, want in seeded["leaves"].items():
            block = shard(np.asarray(want), view, r["specs"][path])
            sharded += block.shape != np.shape(want)
            assert r["blocks"][path].shape == block.shape, path
            assert np.array_equal(r["blocks"][path], block), (rank, path)
    assert sharded > 0  # the tables (and on (2, 2) the MLP weights) are blocks


def test_meshed_save_restores_on_one_device(seeded, save_worlds):
    state = R.elastic_state(torch.device("cpu"), seeded["tree"])
    CheckpointManager(str(save_worlds[2]["dir"])).restore(STEP, target=state)
    for path, t in flatten_state(state):
        assert np.array_equal(t.detach().numpy(), seeded["leaves"][path]), path


# ---------------------------------------------------------------------------
# the elastic drill


@pytest.fixture(scope="module")
def batches():
    src = SyntheticRecSysSource(R.CFG.data, rows=ROWS)
    engine = TorchPreStoEngine(TransformSpec.from_source(src), device="cpu")
    store = PartitionedStore(STEPS, 1, src)
    return [(i, {k: v.numpy() for k, v in engine.produce_batch(store, i).items()})
            for i in range(STEPS)]


def _trainer(seeded, mesh, root: Path, log: Path, dtype: str = "float32") -> ElasticTrainer:
    where = torch.device("cpu") if mesh is None else World(mesh, AXES, "cpu")
    return ElasticTrainer(
        make_mesh=lambda: where,
        make_state=functools.partial(R.elastic_state, tree_path=seeded["tree"], dtype=dtype),
        make_step=functools.partial(R.elastic_step, log_path=str(log), dtype=dtype),
        state_shardings=R.elastic_specs,
        ckpt=CheckpointManager(str(root), async_save=False),
        checkpoint_every=EVERY,
    )


def _params(root: Path) -> dict:
    ck = CheckpointManager(str(root))
    d = Path(ck.step_dir(ck.latest_step()))
    return {p.name: np.load(p) for p in d.glob("params__*.npy")}


def _losses(log: Path) -> dict:
    return {e["step"]: e["loss"] for e in map(json.loads, log.read_text().splitlines())}


def _drill(seeded, batches, dtype: str) -> dict:
    """The failed (1, 2) incarnation in `dtype`, its three resumes and the
    straight runs: each run's final params and logged losses."""
    base = seeded["root"] / f"drill {dtype}"
    failed = base / "failed"
    with pytest.raises(RuntimeError, match="simulated failure at step 3") as err:
        _trainer(seeded, FAILED_MESH, failed, base / "failed.log", dtype).run(
            batches, max_steps=STEPS, fail_at=FAIL_AT)
    out = {"error": str(err.value), "latest": CheckpointManager(str(failed)).latest_step(),
           "failed_losses": _losses(base / "failed.log"), "resumed": {}, "straight": {}}
    # the failed history continued by hand on one device, as a resume there runs it
    state = CheckpointManager(str(failed)).restore(
        2, target=R.elastic_state(torch.device("cpu"), seeded["tree"], dtype))
    step = R.elastic_step(torch.device("cpu"), str(base / "continued.log"), dtype)
    for _, batch in batches[2:]:
        state, _ = step(state, batch)
    out["continued"] = {f"params__{k.replace('.', '__')}.npy": p.detach().numpy()
                        for k, p in state["params"].named_parameters()}
    for name, mesh in RESUMES.items():
        root, log = base / f"resume {name}", base / f"resume {name}.log"
        shutil.copytree(failed, root)
        step, metrics = _trainer(seeded, mesh, root, log, dtype).run(batches, max_steps=STEPS)
        out["resumed"][name] = {"step": step, "loss": metrics["loss"],
                                "params": _params(root), "losses": _losses(log)}
        shutil.rmtree(root)  # read: the drills' checkpoints would fill gigabytes of disk
        root, log = base / f"straight {name}", base / f"straight {name}.log"
        _trainer(seeded, mesh, root, log, dtype).run(batches, max_steps=STEPS)
        out["straight"][name] = {"params": _params(root), "losses": _losses(log)}
        shutil.rmtree(root)
    shutil.rmtree(failed)
    return out


@pytest.fixture(scope="module")
def drill(seeded, batches):
    return _drill(seeded, batches, "float32")


@pytest.fixture(scope="module")
def drill64(seeded, batches):
    """The same drill in f64, where the meshes' other order of sums moves
    no ReLU and no AdamW step."""
    return _drill(seeded, batches, "float64")


def test_one_device_resume_is_the_failed_history_continued(drill):
    """Across topologies the resume itself adds nothing: the one-device
    resume equals restoring the meshed checkpoint by hand and stepping on."""
    got, want = drill["resumed"]["one device"]["params"], drill["continued"]
    assert sorted(got) == sorted(want)
    assert _worst(got, want) <= TOL


def test_failure_leaves_the_checkpoint_of_step_2(drill):
    assert drill["latest"] == 2
    assert "SimulatedFailure" in drill["error"]
    assert sorted(drill["failed_losses"]) == [1, 2, 3]  # steps 0-2 ran, step 3 failed


@pytest.mark.parametrize("name", list(RESUMES))
def test_resume_matches_the_straight_one_device_run(drill, name):
    got, want = drill["resumed"][name], drill["straight"]["one device"]
    assert got["step"] == STEPS and sorted(got["losses"]) == [3, 4]  # replayed from step 2
    for k in got["losses"]:
        assert abs(got["losses"][k] - want["losses"][k]) <= TOL
    assert abs(got["loss"] - want["losses"][STEPS]) <= TOL
    assert sorted(got["params"]) == sorted(want["params"])
    worst = _worst(got["params"], want["params"])
    assert worst <= CROSS_TOL, worst  # steps 0-1 ran on (1, 2)


def _worst(got: dict, want: dict) -> float:
    return max(float(np.abs(got[k] - want[k]).max()) for k in want)


@pytest.mark.parametrize("name", [n for n, m in RESUMES.items() if m is not None])
def test_straight_runs_differ_across_topologies_as_much(drill, name):
    """A mesh alone, with no restart, moves the parameters off the
    one-device run's (up to 3.6e-6 on (1, 2) when written): the resumes'
    bound across topologies is the meshes' own."""
    one = drill["straight"]["one device"]["params"]
    assert _worst(drill["straight"][name]["params"], one) <= CROSS_TOL


@pytest.mark.parametrize("name", [n for n, m in RESUMES.items() if m is not None])
def test_resume_matches_the_straight_run_on_its_mesh(drill, name):
    got, want = drill["resumed"][name], drill["straight"][name]
    assert sorted(want["losses"]) == [1, 2, 3, 4]
    for k in got["losses"]:
        assert abs(got["losses"][k] - want["losses"][k]) <= TOL
    # the (1, 2) resume ran every step on (1, 2); the (1, 4) one its first two
    bound = TOL if RESUMES[name] == FAILED_MESH else CROSS_TOL
    assert _worst(got["params"], want["params"]) <= bound


@pytest.mark.parametrize("name", list(RESUMES))
def test_f64_resume_matches_the_straight_one_device_run(drill64, name):
    """Across topologies within 1e-6 where rounding cannot reach the
    update: in f64 the resumes and the straight runs agree."""
    got, want = drill64["resumed"][name], drill64["straight"]["one device"]
    assert got["step"] == STEPS and sorted(got["losses"]) == [3, 4]
    for k in got["losses"]:
        assert abs(got["losses"][k] - want["losses"][k]) <= TOL
    assert all(v.dtype == np.float64 for v in got["params"].values())
    assert _worst(got["params"], want["params"]) <= TOL


@pytest.mark.parametrize("name", [n for n, m in RESUMES.items() if m is not None])
def test_f64_straight_runs_agree_across_topologies(drill64, name):
    straight = drill64["straight"]
    for k, loss in straight["one device"]["losses"].items():
        assert abs(straight[name]["losses"][k] - loss) <= TOL
    assert _worst(straight[name]["params"], straight["one device"]["params"]) <= TOL


@pytest.mark.parametrize("name", [n for n, m in RESUMES.items() if m is not None])
def test_f64_resume_matches_the_straight_run_on_its_mesh(drill64, name):
    got, want = drill64["resumed"][name], drill64["straight"][name]
    assert _worst(got["params"], want["params"]) <= TOL


def test_meshed_incarnation_defaults_to_cuda_and_raises_without_it(seeded, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    trainer = _trainer(seeded, (1, 2), tmp_path, tmp_path / "log")
    trainer.make_mesh = lambda: World((1, 2), AXES)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trainer.run([], max_steps=1)
    with pytest.raises(ValueError, match="bootstraps in its ranks"):
        trainer.bootstrap()
