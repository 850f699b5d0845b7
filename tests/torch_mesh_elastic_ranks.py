"""Rank programs of ``test_torch_mesh_elastic.py``, run by
``launch.mesh.run_spmd`` on CPU ranks over gloo.

They live apart from the test file so that a spawned rank imports only
torch and the port.  The elastic drill's ``make_state``, ``make_step`` and
``state_shardings`` are module-level too: ``ElasticTrainer.run`` pickles
them to the ranks of each incarnation (bound to their arguments with
``functools.partial``).
"""

from __future__ import annotations

import json

import numpy as np
import torch

from repro_torch.configs.registry import get_recsys
from repro_torch.distributed.sharding import ShardingRules, shard
from repro_torch.launch.mesh import Mesh
from repro_torch.models import recsys as RS
from repro_torch.train import CheckpointManager, adamw, init_state, make_train_step, warmup_cosine
from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train.checkpoint import flatten_state

CFG = get_recsys("rm2", reduced=True)
LR = (1e-3, 2, 100)


def optimizer():
    return adamw(warmup_cosine(*LR))


def rules_of(where):
    """Meshed rules on a rank's mesh; None on one device."""
    return ShardingRules.make(where) if isinstance(where, Mesh) else None


def load_tree(path: str) -> dict:
    """The reference's nested params from an ``.npz`` of ``group/name`` keys."""
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            *groups, leaf = key.split("/")
            d = tree
            for g in groups:
                d = d.setdefault(g, {})
            d[leaf] = z[key]
    return tree


def elastic_state(where, tree_path: str, dtype: str = "float32"):
    """make_state: a fresh TrainState from the reference's initial params in
    `dtype`, the rank's blocks on a mesh."""
    device = where.device if isinstance(where, Mesh) else where
    model = RS.params_from_numpy(load_tree(tree_path), CFG, device, rules=rules_of(where))
    return init_state(model.to(getattr(torch, dtype)), optimizer())


def elastic_specs(mesh):
    """state_shardings: the DLRM state's spec tree on `mesh`."""
    return RS.state_pspecs(CFG, ShardingRules.make(mesh), optimizer())


def elastic_step(where, log_path: str, dtype: str = "float32"):
    """make_step: the (meshed) train step on the rank's rows of each global
    numpy batch, its floats in `dtype`; rank 0 (or the one device) appends
    each step's loss to `log_path`."""
    rules = rules_of(where)
    loss = lambda m, b: RS.loss_fn(m, b, CFG, rules)  # noqa: E731
    if rules is None:
        step = make_train_step(loss, optimizer())
        row = None
    else:
        step = make_train_step(loss, optimizer(), rules=rules,
                               param_specs=RS.flat_param_pspecs(CFG, rules))
        row = rules.pspec("batch")

    def run(state, batch):
        local = {k: torch.from_numpy(np.array(v if row is None else shard(v, where, row)))
                 for k, v in batch.items()}
        local = {k: v.to(getattr(torch, dtype)) if v.is_floating_point() else v
                 for k, v in local.items()}
        state, metrics = step(state, local)
        if not isinstance(where, Mesh) or where.rank == 0:
            with open(log_path, "a") as f:
                f.write(json.dumps({"step": int(state["step"]),
                                    "loss": float(metrics["loss"])}) + "\n")
        return state, metrics

    return run


def save_restore_rank(mesh, tree_path: str, ref_dir: str, out_dir: str, step: int,
                      chunk_bytes: int) -> dict:
    """Restore the reference's checkpoint of `step` into fresh blocks (each
    rank's blocks go back to the test), then save them as a meshed
    checkpoint under `out_dir`; chunks of `chunk_bytes`.  Also what
    ``latest_step()`` reads on this rank once the save has returned."""
    ckpt_mod.CHUNK_BYTES = chunk_bytes
    state = elastic_state(mesh, tree_path)
    specs = elastic_specs(mesh)
    CheckpointManager(ref_dir).restore(step, target=state, mesh=mesh, specs=specs)
    blocks = {name: t.detach().numpy().copy() for name, t in flatten_state(state)}
    out = CheckpointManager(out_dir)
    out.save(step, state, mesh=mesh, specs=specs)
    return {"coords": mesh.coords, "blocks": blocks, "latest": out.latest_step(),
            "specs": dict(flatten_state(specs))}
