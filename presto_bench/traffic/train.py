"""The train driver (``"driver": "train"``): the DLRM trained by AdamW on
batches that a PreSto session delivers (the paper's Fig. 1 and Fig. 3
loop), driven as the program's training driver wires it
(``repro_torch.launch.train.train_recsys``): ``TorchPreStoEngine`` ->
``PreprocessingService`` session -> ``TrainingPipeline.run_session`` -> the
training driver's AdamW step (``launch.train.recsys_step``).  The traffic
file gives the session: ``workers``, ``queue_depth``, ``megabatch``,
``placement`` and ``use_cache`` (the feature cache).

Set-up writes the traffic's pool of partition files, links further
partition ids to them so that the session outlasts the window, draws the
weights on the device from the seed, and starts the session.  The first
steps are set-up: the first ``check_steps`` of them are the steps the
reference replays, and the window starts when ``warmup_steps`` steps have
completed.  The benchmark wraps the train step that ``run_session`` calls:
each call ends in a device sync, and once ``seconds`` have passed since the
window started, the wrapper cancels the session, so the window ends at a
step's sync.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import torch

from presto_bench.harness import check, inputs
from presto_bench.harness.common import Run, Tracer, log, steady, sync
from presto_bench.reference import draw


class _Feed:
    """The session, as ``run_session`` iterates it, noting each batch's
    partition id."""

    def __init__(self, session):
        self.session = session
        self.pid = None

    def __iter__(self):
        for pid, batch in self.session:
            self.pid = pid
            yield pid, batch

    def __getattr__(self, name):
        return getattr(self.session, name)


class _Driver:
    """The train step as ``run_session`` calls it, with the window's clock."""

    def __init__(self, run: Run, step, feed: _Feed, model_cfg: Dict, data: Dict, b1: float):
        self.run, self.step, self.feed = run, step, feed
        self.model_cfg, self.data, self.b1 = model_cfg, data, b1
        tr = run.traffic
        self.check_steps, self.warmup = tr["check_steps"], tr["warmup_steps"]
        self.tracer = Tracer(tr["trace_steps"], run.device)
        self.files = tr["files"]
        # window batches of the files that the checked steps read
        self.sample = inputs.Sample(run.seed, tr["check_window_batches"])
        self.check_files = set()
        self.n = 0
        self.t0 = self.t_end = None
        self.ends: List[float] = []
        self.rows = 0
        self.stats0 = self.stats1 = None
        self.losses: List[float] = []
        self.kept = []  # (partition id, batch) of the checked steps
        self.grad = self.change = None

    def __call__(self, state, batch):
        state, metrics = self.step(state, batch)
        sync(self.run.device)
        t = time.perf_counter()
        self.n += 1
        i = self.n
        if i <= self.check_steps:
            self.losses.append(float(metrics["loss"]))
            self.kept.append((self.feed.pid, {k: v.cpu() for k, v in batch.items()}))
            self.check_files.add(self.feed.pid % self.files)
            if i == 1:
                self.grad = program_grad_norms(state, self.b1)
            if i == self.check_steps:
                self.change = program_change_norms(state, self.model_cfg, self.data,
                                                   self.run.seed, self.run.device)
            sync(self.run.device)
            t = time.perf_counter()
        if i <= self.warmup:
            log(f"setup: step {i}, {t - self.run.t_start:.3f} s")
        if i == self.warmup:
            steady()
            t = time.perf_counter()
            self.t0 = t
            self.stats0 = self.feed.stats()
        elif i > self.warmup and self.t_end is None:
            self.ends.append(t)
            self.rows += int(batch["labels"].shape[0])
            if self.feed.pid % self.files in self.check_files:
                self.sample.offer((self.feed.pid, batch))
            if t - self.t0 >= self.run.seconds:
                self.t_end = t
                self.stats1 = self.feed.stats()
                if not (self.run.trace and self.tracer.tick()):
                    self.feed.cancel()
        elif self.t_end is not None and not self.tracer.tick():  # traced stretches, after it
            self.feed.cancel()
        return state, metrics


def program_params(model_cfg: Dict, data: Dict, seed: int, device) -> Dict:
    """The drawn weights in the program's layout: one (T, R, D) table tensor
    and the MLPs' groups."""
    leaves = list(draw.leaf_specs(model_cfg, data))
    n_tables = sum(1 for name, *_ in leaves if name.startswith("tables."))
    rows, dim = data["embedding_rows"], model_cfg["emb_dim"]
    tables = torch.empty((n_tables, rows, dim), dtype=torch.float32, device=device)
    params: Dict = {"tables": tables, "bottom": {}, "bottom_b": {}, "top": {}, "top_b": {}}
    for name, shape, std, idx in leaves:
        leaf = draw.draw_leaf(shape, std, idx, seed, device)
        if name.startswith("tables."):
            tables[int(name.split(".")[1])].copy_(leaf)
        else:
            group, key = name.split(".")
            params[group][key] = leaf
        del leaf
    return params


def _program_leaves(state) -> Dict[str, torch.Tensor]:
    """The model's parameters by the reference's leaf names (a table each)."""
    out = {}
    for name, p in state["params"].named_parameters():
        if name == "tables":
            out.update({f"tables.{t}": p.detach()[t] for t in range(p.shape[0])})
        else:
            out[name] = p.detach()
    return out


def program_grad_norms(state, b1: float) -> Dict[str, float]:
    """Each leaf's norm of the first step's clipped gradient, from AdamW's
    first moment after one step (m = (1 - b1) g)."""
    out = {}
    for name, m in state["opt"]["m"].items():
        if name == "tables":
            for t in range(m.shape[0]):
                out[f"tables.{t}"] = check.norm(m[t]) / (1 - b1)
        else:
            out[name] = check.norm(m) / (1 - b1)
    return out


def program_change_norms(state, model_cfg: Dict, data: Dict, seed: int, device) -> Dict[str, float]:
    """Each leaf's norm of its change since the drawn weights."""
    leaves = _program_leaves(state)
    out = {}
    with torch.no_grad():
        for name, shape, std, idx in draw.leaf_specs(model_cfg, data):
            w0 = draw.draw_leaf(shape, std, idx, seed, device)
            out[name] = check.norm(leaves[name] - w0)
            del w0
    return out


def run(run: Run) -> Dict:
    from repro_torch.core.pipeline import TrainingPipeline
    from repro_torch.core.presto import TorchPreStoEngine
    from repro_torch.core.service import JobSpec, PreprocessingService
    from repro_torch.launch.train import recsys_step
    from repro_torch.models import recsys as RS
    from repro_torch.train import init_state

    cfg, tr = run.cfg, run.traffic
    data = inputs.data_config(cfg, tr)
    spec, params_np = inputs.transform_spec(data, run.seed)
    engine = TorchPreStoEngine(spec, placement=tr["placement"], device=run.device)
    rcfg = inputs.recsys_config(cfg, spec)
    model = RS.DLRM(rcfg, program_params(cfg["model"], data, run.seed, run.device))
    t = cfg["train"]
    opt, step = recsys_step(rcfg, t["lr"], t["schedule_steps"])
    state = init_state(model, opt)
    sync(run.device)
    log(f"setup: weights and optimizer state, {time.perf_counter() - run.t_start:.3f} s")
    run.partitions.wait()
    log(f"setup: {tr['files']} partition files written, {time.perf_counter() - run.t_start:.3f} s")
    store = run.partitions.store
    with PreprocessingService(num_workers=tr["workers"]) as service:
        session = service.submit(JobSpec(
            name=run.cell, partitions=range(tr["partition_ids"]), engine=engine,
            store=store, units=tr["workers"], queue_depth=tr["queue_depth"],
            megabatch=tr["megabatch"], use_cache=tr["use_cache"]))
        feed = _Feed(session)
        driver = _Driver(run, step, feed, cfg["model"], data, t["b1"])
        state, _, _ = TrainingPipeline(train_step=driver).run_session(state, feed)
    steady(False)
    if driver.t_end is None:
        raise RuntimeError(f"the session ended after {driver.n} steps, before the window "
                           f"closed; give the traffic more partition ids")
    memory_peak = torch.cuda.max_memory_allocated(run.device) if run.device.type == "cuda" else 0
    window_s = driver.t_end - driver.t0
    steps = len(driver.ends)
    intervals = [b - a for a, b in zip([driver.t0] + driver.ends, driver.ends)]
    s0, s1 = driver.stats0, driver.stats1
    produced = s1.produced - s0.produced
    ctx = dict(driver.tracer.ctx(), **{
        "kind": "train", "setup_s": driver.t0 - run.t_start, "window_s": window_s,
        "units": steps, "rows": driver.rows, "intervals_s": intervals,
        "produce_s": s1.produce_time_s - s0.produce_time_s, "produced": produced,
        "feed_wait_s": s1.wait_time_s - s0.wait_time_s,
        "model": cfg["model"], "data": data,
    })
    kept = driver.kept + driver.sample.items
    grad, change, losses = driver.grad, driver.change, driver.losses
    del state, model, opt, step, driver, feed, session, engine, service
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    numbers, ref = check.train_numbers(run, cfg, data, params_np, kept, losses, grad, change)
    return {"ctx": ctx, "numbers": numbers, "memory_peak_bytes": memory_peak,
            "attempted": steps, "failed": 0,
            "detail": {"grad": grad, "change": change, "reference": ref,
                       "files": [pid % tr["files"] for pid, _ in kept[:len(losses)]]}}
