"""Rank programs of ``test_torch_mesh.py``, run by ``launch.mesh.run_spmd``
on CPU ranks over gloo.

They live apart from the test file so that a spawned rank imports only
torch and the port (the test file also imports jax and the JAX package).
Each takes the rank's mesh first, gets its inputs as numpy, and returns
numpy or plain Python to the test, which compares them with the JAX
package and the port's one-device path.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.registry import get_recsys
from repro_torch.core.presto import TorchPreStoEngine, gather_minibatch
from repro_torch.core.spec import TransformSpec
from repro_torch.data.storage import PartitionedStore
from repro_torch.data.synth import RMDataConfig, SyntheticRecSysSource
from repro_torch.distributed import comm
from repro_torch.distributed.sharding import ShardingRules, shard
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import recsys as RS
from repro_torch.train import (
    Optimizer,
    adamw,
    crosspod_compressed_mean,
    init_state,
    make_compressed_train_step,
    make_train_step,
    warmup_cosine,
)

# the reference's sharded tests' geometry (tests/test_sharded.py)
SMALL = RMDataConfig("t", 4, 3, 4, 8, 2, 32, 1 << 16, 1024, rows_per_partition=256)
ROWS = 256
DEDUP = 4
# placement name -> (placement, kernel_mode); hybrid as the reference's
# per-family dict (at this geometry the cost model keeps all on ISP)
PLACEMENTS = {
    "presto": ("presto", None),
    "hybrid": ({"gen": "host", "lengths": "host"}, None),
    "disagg": ("disagg", None),
    "unfused": ("disagg", "unfused"),
}
COLLECTIVES = ("all_reduce", "all_gather", "batch_isend_irecv", "broadcast",
               "isend", "irecv", "send", "recv", "reduce_scatter", "all_to_all")


def small_source(dup: int = 1) -> SyntheticRecSysSource:
    return SyntheticRecSysSource(dataclasses.replace(SMALL, dup_factor=dup), rows=ROWS)


@contextlib.contextmanager
def collectives_raise():
    """Every torch.distributed collective raises while inside."""
    saved = {name: getattr(dist, name) for name in COLLECTIVES}

    def refuse(*args, **kwargs):
        raise AssertionError("a collective was called")

    try:
        for name in COLLECTIVES:
            setattr(dist, name, refuse)
        yield
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def _numpy(batch) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in batch.items()}


def preprocess_rank(mesh) -> dict:
    """Partition 0 of the small store under every placement and, deduped
    (dup 4), under presto and disagg: per-rank collective bytes and calls,
    the gathered global batches (rank 0), and presto once more with every
    collective raising."""
    src = small_source()
    spec = TransformSpec.from_source(src)
    store = PartitionedStore(2, 2, src)
    out = {"bytes": {}, "calls": {}, "batches": {}, "dedup": {},
           "host_mesh": dict(make_host_mesh(device="cpu").shape)}
    with collectives_raise():
        quiet = TorchPreStoEngine(spec, mesh, placement="presto", device="cpu")
        out["raising"] = _numpy(quiet.produce_batch(store, 0))
    for name, (placement, kernel_mode) in PLACEMENTS.items():
        engine = TorchPreStoEngine(spec, mesh, placement=placement,
                                   kernel_mode=kernel_mode, device="cpu")
        mesh.counter.reset()
        local = engine.produce_batch(store, 0)
        out["bytes"][name] = dict(mesh.counter.bytes)
        out["calls"][name] = dict(mesh.counter.calls)
        out.setdefault("host_families", {})[name] = engine.host_families()
        whole = gather_minibatch(local, mesh)
        if mesh.rank == 0:
            out["batches"][name] = _numpy(whole)
    dsrc = small_source(DEDUP)
    dspec = TransformSpec.from_source(dsrc)
    dstore = PartitionedStore(2, 2, dsrc)
    for name in ("presto", "disagg"):
        engine = TorchPreStoEngine(dspec, mesh, placement=name, device="cpu")
        whole = gather_minibatch(engine.produce_batch(dstore, 0), mesh)
        if mesh.rank == 0:
            out["dedup"][name] = _numpy(whole)
    return out


def embedding_rank(mesh, tables, mids, lens, oids, w) -> dict:
    """The row-sharded bag of the rank's batch rows over its table rows,
    and the gradient of sum(pooled * w) over the whole batch for its rows
    (summed over data)."""
    rows = ("data",)
    local = torch.from_numpy(np.array(shard(tables, mesh, (None, "model", None))))
    local.requires_grad_(True)
    args = [torch.from_numpy(np.array(shard(x, mesh, rows))) for x in (mids, lens, oids, w)]
    pooled = RS.sharded_embedding_bag(local, *args[:3], mesh, "model")
    (pooled * args[3]).sum().backward()
    grad = comm.psum(local.grad, mesh, "data")
    return {"coords": mesh.coords, "pooled": pooled.detach().numpy(), "grad": grad.numpy()}


def _local_batch(batch: dict, mesh, rules) -> dict:
    """The rank's rows of a global batch (numpy) under rules' batch axes."""
    row = rules.pspec("batch")
    return {k: torch.from_numpy(np.array(shard(v, mesh, row))) for k, v in batch.items()}


def _blocks(model) -> dict:
    return {k: v.detach().numpy().copy() for k, v in model.named_parameters()}


def train_rank(mesh, params, batches, lr) -> dict:
    """Meshed train steps at reduced rm2 from the reference's params: the
    losses, grad norms and the rank's parameter blocks after the steps."""
    cfg = get_recsys("rm2", reduced=True)
    rules = ShardingRules.make(mesh)
    model = RS.params_from_numpy(params, cfg, "cpu", rules=rules)
    specs = RS.flat_param_pspecs(cfg, rules)
    opt = adamw(warmup_cosine(*lr))
    state = init_state(model, opt)
    step = make_train_step(lambda m, b: RS.loss_fn(m, b, cfg, rules), opt,
                           rules=rules, param_specs=specs)
    losses, norms = [], []
    for batch in batches:
        state, metrics = step(state, _local_batch(batch, mesh, rules))
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    return {"coords": mesh.coords, "specs": specs, "losses": losses, "norms": norms,
            "params": _blocks(model)}


def compression_rank(mesh, grads, errs, specs) -> dict:
    """``crosspod_compressed_mean`` of per-pod gradients (grads[pod], the
    pod's global tensors), sharded within the pod by `specs`."""
    pod = mesh.coords["pod"]
    mine = {k: torch.from_numpy(np.array(shard(v[pod], mesh, specs[k]))) for k, v in grads.items()}
    err = {k: torch.from_numpy(np.array(shard(v[pod], mesh, specs[k]))) for k, v in errs.items()}
    mean, new_err = crosspod_compressed_mean(mine, err, mesh, "pod", specs)
    return {"coords": mesh.coords, "mean": {k: v.numpy() for k, v in mean.items()},
            "err": {k: v.numpy() for k, v in new_err.items()}}


def recording(opt: Optimizer, seen: list) -> Optimizer:
    """`opt`, keeping a copy of the gradients each update receives (the
    update scales them in place)."""

    def update(grads, state, params, sq_sum=None):
        seen.append({k: g.detach().clone().numpy() for k, g in grads.items()})
        return opt.update(grads, state, params, sq_sum)

    return Optimizer(opt.init, update)


def compressed_step_rank(mesh, params, batch, lr) -> dict:
    """Two compressed steps over (pod, data, model), and from the same
    params and batch one uncompressed meshed step and one step averaged
    within the pod only: losses, the largest parameter difference after
    one step, the pod hop's bytes, and the rank's blocks of the gradients
    that each first update received (compressed, global mean, pod mean) and
    of the error feedback after the first compressed step."""
    cfg = get_recsys("rm2", reduced=True)
    inner = ShardingRules.make(mesh, overrides={"batch": ("data",)})
    outer = ShardingRules.make(mesh)
    specs = RS.flat_param_pspecs(cfg, inner)
    opt = adamw(warmup_cosine(*lr))
    local = _local_batch(batch, mesh, outer)
    seen = {"compressed": [], "global": [], "pod": []}

    model = RS.params_from_numpy(params, cfg, "cpu", rules=inner)
    state = init_state(model, opt, with_err=True)
    cstep = make_compressed_train_step(lambda m, b: RS.loss_fn(m, b, cfg, inner),
                                       recording(opt, seen["compressed"]), inner, specs)
    mesh.counter.reset()
    state, m1 = cstep(state, local)
    compressed = {"bytes": dict(mesh.counter.bytes), "calls": dict(mesh.counter.calls)}
    after_one = _blocks(model)
    err = {k: v.numpy().copy() for k, v in state["err"].items()}
    state, m2 = cstep(state, local)

    for name, rules in (("global", outer), ("pod", inner)):
        umodel = RS.params_from_numpy(params, cfg, "cpu", rules=inner)
        ustep = make_train_step(lambda m, b, r=rules: RS.loss_fn(m, b, cfg, r),
                                recording(opt, seen[name]), rules=rules, param_specs=specs)
        mesh.counter.reset()
        ustep(init_state(umodel, opt), local)
        if name == "global":
            uncompressed = {"bytes": dict(mesh.counter.bytes),
                            "calls": dict(mesh.counter.calls)}
            diff = max(float(np.max(np.abs(after_one[k] - v)))
                       for k, v in _blocks(umodel).items())
    numel = {k: int(v.size) for k, v in after_one.items()}
    return {"coords": mesh.coords, "losses": [float(m1["loss"]), float(m2["loss"])],
            "max_diff": diff, "compressed": compressed, "uncompressed": uncompressed,
            "numel": numel, "specs": specs, "err": err,
            "grads": {k: v[0] for k, v in seen.items()}}


def pods_rank(mesh, compression_args, step_args) -> dict:
    """``compression_rank`` and ``compressed_step_rank`` in one world."""
    return {"compression": compression_rank(mesh, *compression_args),
            "step": compressed_step_rank(mesh, *step_args)}


def failing_rank(mesh) -> None:
    """Rank 1 raises; rank 0 returns and then waits for it."""
    if mesh.rank == 1:
        raise ValueError("rank 1 fails on purpose")
