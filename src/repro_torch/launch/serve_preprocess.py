"""serve_preprocess: N concurrent synthetic jobs on one shared ISP pool.

The port's server entry point: the JAX package's ``serve_preprocess``
over ``repro_torch``, with the same flags plus
``--device`` (CUDA by default, raising when no card is present; ``cpu`` runs
the kernels' plain PyTorch versions).  Every tenant's engine and the shared
feature cache live on that device.  ``--verify`` copies each delivered
batch and its solo recompute to the host and compares every key bitwise
(the same engine on the same device).  ``main`` returns the per-job
``SessionStats`` it prints.

Drives the preprocessing-as-a-service surface end to end: a
``PreprocessingService`` pool serves N tenants, each a synthetic RM job with
its own partition range, placement, and (optional) QoS target; every tenant
is drained by its own consumer thread that simulates a trainer (a fixed
per-batch train time).  Prints the paper's Fig. 3 accounting per job —
utilization, starvation, straggler re-issues, feature-cache hits, the pool
workers' produce seconds with their staging and ``engine.deliver`` wait
parts (``SessionStats.stage_time_s``, ``deliver_wait_s``) — plus the pool's
unit shares.

With ``--cache`` the pool carries a shared content-addressed feature cache
(``core.featcache``): tenants of the same RM generate identical partition
content (deterministic synthetic sources), so overlapping work deduplicates
across tenants even though every job builds its own store object.

``--dup-factor D`` makes every tenant's dataset sample-level deduped
(RecD): each session's sparse feature block repeats D times, partitions are
stored and staged as unique blocks + per-sample refs (the stores charge
only unique bytes — watch the dedup summary line), and with ``--cache`` the
shared block tier assembles repeat partitions from other tenants' published
blocks (the blk column, hits/published; ``--dup-pool`` sizes the shared
dataset-level block pool that gives tenants real overlap).

The pool's units are bound to a shared ``data.storage.DeviceFleet`` of
``--devices`` simulated ISP devices: every tenant's partitions live on (and
charge) those devices, claims are locality-aware, and skewed ownership
(``--skew``) drives hot devices past the fallback threshold.  A per-device
utilization table (occupancy, queue depth, fallbacks) prints after the
per-job table.

The pool is ELASTIC (``core.ctrlplane``): ``--kill WID@N`` crash-simulates
pool workers mid-job (their claims re-issue through the straggler path),
``--restart-after N`` checkpoints every half-drained session, tears the
whole service down, and resumes bitwise-identically on a fresh one,
``--autoscale MIN:MAX`` runs the backlog-driven policy loop, and
``--verify`` recomputes every delivered batch solo and asserts the chaos
run's output is bitwise identical and complete.  Every membership change,
re-issue, checkpoint, and scale decision lands in the structured event
stream (summarized at exit; ``--events-out`` writes the JSON artifact).

The STORAGE fault domain is drillable too (``data.storage.IoFaultInjector``):
``--io-faults SPEC`` seeds deterministic I/O chaos into every tenant's store
— transient read errors, torn (bit-flipped) blocks caught by end-to-end
content digests, slow reads, spill-block corruption, and a whole device
knocked offline mid-run.  Sessions absorb the faults through bounded
retry/backoff, device failover, and per-partition quarantine; with
``--verify`` the drill asserts the faulted run's output is still bitwise
identical to a fault-free solo recompute.  The exit code is non-zero when
verification fails or any session ends with a quarantined partition.

    PYTHONPATH=src python -m repro_torch.launch.serve_preprocess --jobs 2 --reduced
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import tempfile
import threading
import time

import numpy as np
import torch

from repro_torch.common.util import resolve_device
from repro_torch.configs.registry import get_recsys
from repro_torch.core.costmodel import ContentionAwareCostModel
from repro_torch.core.ctrlplane import Autoscaler, AutoscalePolicy, parse_kill_spec
from repro_torch.core.featcache import FeatureCache, default_spill_store
from repro_torch.core.presto import TorchPreStoEngine
from repro_torch.core.service import JobSpec, PreprocessingService
from repro_torch.core.spec import TransformSpec
from repro_torch.data.storage import (
    DeviceFleet,
    PartitionedStore,
    parse_iofault_spec,
    zipf_owner_map,
)
from repro_torch.data.synth import SyntheticRecSysSource

EPILOG = """\
device flag:
  --device DEV               where every engine and the feature cache run
                             (default cuda; raises when no card is present;
                             cpu runs the kernels' plain PyTorch versions)
multi-tenant flags:
  --jobs N --workers M       N tenants share a pool of M units (admission
                             guarantees each tenant 1 unit or rejects it)
  --qos S                    per-job QoS target in samples/s; demand is
                             re-estimated as ceil(target / measured P)
device flags:
  --devices N                shared fleet of N simulated ISP devices; pool
                             units bind to devices round-robin and claims
                             prefer the partition's owning device (0 = the
                             legacy fungible pool, no device table)
  --skew ALPHA               Zipf(ALPHA)-skewed partition->device ownership
                             shared by every tenant: hot devices queue past
                             the fallback threshold and shed work to the
                             host (watch the fallback column; 0 = uniform)
cache flags:
  --cache                    shared content-addressed feature cache across
                             tenants (keys: partition fingerprint x lowered
                             opgraph hash x placement)
  --cache-mb MB              in-memory LRU tier bound (default 256 MB)
  --spill-devices K          add a spill tier on K simulated storage devices
                             (evictions land there; 0 = no spill tier; K ==
                             --devices reuses the shared fleet's ledgers)
dedup flags:
  --dup-factor D             sample-level dedup (RecD): every session's
                             sparse block repeats D times; partitions stage
                             as unique blocks + refs, stores charge unique
                             bytes only (D=1 = classic layout; rows/D must
                             be a multiple of 32)
  --dup-pool P               dataset-level shared block pool (default 16):
                             blocks repeat ACROSS partitions and tenants,
                             so the shared cache's block tier can assemble
                             one tenant's partitions from another's blocks
pipeline flags:
  --megabatch K              pool workers coalesce up to K same-job claims
                             into ONE megabatched kernel launch (bitwise
                             identical to solo launches, one dispatch)
  --autotune                 let the online MegabatchTuner pick K per job:
                             seeded from the cost model, hill-climbed from
                             measured launch timings (--megabatch becomes
                             the K cap; watch the tunedK column)
  --lookahead D              stage up to D chunks of future claims behind
                             the in-flight kernel (byte-budgeted; D=1 is
                             the classic double buffer) and pre-warm cache
                             leases over the peek window
  --no-prewarm               keep the lookahead window but skip issuing
                             cache pre-warm leases ahead of the cursor
  --no-pipeline              legacy serial worker loop: no megabatching, no
                             read/compute overlap (A/B baseline)
control-plane flags (core.ctrlplane):
  --kill WID@N               crash-simulate pool worker WID once N total
                             batches have been delivered (repeatable); its
                             in-flight claims re-issue via the straggler
                             path — output stays bitwise identical
  --restart-after N          after N total delivered batches: checkpoint
                             every unfinished session, close the service,
                             rebuild it, and resume from the checkpoints
  --autoscale MIN:MAX        run the backlog-driven autoscaler between MIN
                             and MAX workers (scale decisions land in the
                             event stream)
  --autoscale-interval S     policy evaluation period in seconds (0.05)
  --io-faults SPEC           seeded I/O fault injection into every store:
                             comma-joined knobs out of transient=P
                             (retryable read errors), corrupt=P (torn
                             blocks, caught by content digests), spill=P
                             (spill-block corruption), slow=P[:SECONDS],
                             offline=DEV@N (device DEV dies after N reads),
                             seed=K — e.g.
                             transient=0.2,corrupt=0.1,offline=1@8,seed=7
  --io-retries N             per-partition retry budget before quarantine
                             (default 3); --io-backoff-ms is the base of
                             the exponential backoff (default 10)
  --verify                   recompute every delivered batch solo; assert
                             the (chaos) run delivered every partition,
                             bitwise identical
  --events-out PATH          dump the structured event stream (all service
                             incarnations, JSON) for CI artifact upload

examples:
  PYTHONPATH=src python -m repro_torch.launch.serve_preprocess --jobs 2 --reduced
  PYTHONPATH=src python -m repro_torch.launch.serve_preprocess \\
      --jobs 2 --reduced --autotune --lookahead 4
  PYTHONPATH=src python -m repro_torch.launch.serve_preprocess \\
      --jobs 3 --reduced --cache --cache-mb 64 --spill-devices 4
  PYTHONPATH=src python -m repro_torch.launch.serve_preprocess \\
      --jobs 2 --reduced --devices 4 --skew 1.1
  PYTHONPATH=src python -m repro_torch.launch.serve_preprocess \\
      --jobs 2 --reduced --kill 1@3 --restart-after 8 --verify \\
      --events-out EVENTS_chaos.json
  PYTHONPATH=src python -m repro_torch.launch.serve_preprocess \\
      --jobs 2 --reduced --workers 2 --units 3 --autoscale 2:6
  PYTHONPATH=src python -m repro_torch.launch.serve_preprocess \\
      --jobs 2 --reduced --cache --spill-devices 4 --verify \\
      --io-faults transient=0.2,corrupt=0.1,spill=0.3,offline=1@8,seed=7 \\
      --events-out EVENTS_iofaults.json
"""


def _bits(t: torch.Tensor) -> np.ndarray:
    """A tensor's bits on the host: floats as their int32 words, so the
    comparison is bitwise (NaN payloads and signed zeros included)."""
    a = t.detach().cpu().numpy()
    return a.view(np.int32) if a.dtype == np.float32 else a


class _Counter:
    """Total delivered batches across every tenant (the chaos thresholds)."""

    def __init__(self):
        self.n = 0
        self.cond = threading.Condition()

    def bump(self) -> None:
        with self.cond:
            self.n += 1
            self.cond.notify_all()


def _consume(session, consume_s: float, result: dict, got: dict,
             counter: _Counter) -> None:
    """A tenant's trainer: drain the session, spending consume_s per batch.

    Accumulates across service incarnations (the restart drill re-enters
    with the resumed session).  A RuntimeError is the service being torn
    down mid-stream — recorded, not raised; main() re-raises unless a
    restart was actually requested."""
    busy = 0.0
    batches = 0
    t0 = time.perf_counter()
    try:
        for pid, mb in session:
            s0 = time.perf_counter()
            if consume_s > 0:
                time.sleep(consume_s)  # stand-in for the accelerator step
            busy += time.perf_counter() - s0
            batches += 1
            got[pid] = mb
            counter.bump()
    except RuntimeError as e:
        result["interrupted"] = repr(e)
    result["busy_s"] = result.get("busy_s", 0.0) + busy
    result["batches"] = result.get("batches", 0) + batches
    result["wall_s"] = result.get("wall_s", 0.0) + (time.perf_counter() - t0)


def _chaos_monitor(service, counter: _Counter, kills, restart_after,
                   do_restart) -> None:
    """Applies --kill / --restart-after directives as the global delivered
    count crosses their thresholds."""
    pending = sorted(kills)
    while pending or restart_after is not None:
        with counter.cond:
            counter.cond.wait(timeout=0.1)
            n = counter.n
        while pending and n >= pending[0][0]:
            after, wid = pending.pop(0)
            ok = service.kill_worker(wid)
            print(f"chaos: killed worker {wid} after {after} delivered "
                  f"batch(es)" if ok else
                  f"chaos: worker {wid} already gone at {after} batches")
        if restart_after is not None and n >= restart_after:
            print(f"chaos: restarting the service after {restart_after} "
                  f"delivered batch(es)")
            do_restart()
            return
        if service.closed:
            return


def verify_delivered(jobspecs, gots, stores, specs, partitions: int,
                     placement, device) -> None:
    """The chaos acceptance gate of ``--verify``: every partition delivered
    exactly once per tenant's output map, bitwise identical to a solo
    recompute on the same device (reads go clean: the injector must not
    fault the reference).  Each key is compared on host copies."""
    for store in stores.values():
        store.fault_injector = None
    for job in jobspecs:
        got = gots[job.name]
        missing = sorted(set(range(partitions)) - set(got))
        if missing:
            raise AssertionError(f"job {job.name} missing partitions {missing}")
        engine = TorchPreStoEngine(specs[job.name],
                                   placement=placement, device=device)
        for pid, mb in sorted(got.items()):
            want = engine.produce_batch(stores[job.name], pid)
            if sorted(mb) != sorted(want):
                raise AssertionError(f"job {job.name} pid {pid}: keys {sorted(mb)}")
            for key in want:
                np.testing.assert_array_equal(
                    _bits(mb[key]), _bits(want[key]),
                    err_msg=f"job {job.name} pid {pid} key {key}")
    print(f"verify: {len(jobspecs)} job(s) x {partitions} partitions "
          f"bitwise identical to solo recompute")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description=__doc__, epilog=EPILOG,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--jobs", type=int, default=2, help="concurrent tenants")
    ap.add_argument("--workers", type=int, default=None,
                    help="pool size (default: jobs + 1)")
    ap.add_argument("--rm", nargs="+", default=["rm1"],
                    help="RM configs, assigned round-robin to jobs")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced RM geometries (CI-sized)")
    ap.add_argument("--rows", type=int, default=256, help="rows per partition")
    ap.add_argument("--partitions", type=int, default=6, help="partitions per job")
    ap.add_argument("--placement", default="presto",
                    choices=("presto", "disagg", "hybrid"))
    ap.add_argument("--qos", type=float, default=None,
                    help="per-job QoS target (samples/s); default best-effort")
    ap.add_argument("--units", type=int, default=None,
                    help="explicit per-job demand units (the autoscaler's "
                         "demand cap; default: estimated)")
    ap.add_argument("--consume-ms", type=float, default=5.0,
                    help="simulated train-step time per batch")
    ap.add_argument("--devices", type=int, default=4,
                    help="shared fleet of N simulated ISP devices the pool "
                         "binds to (0 = legacy fungible pool)")
    ap.add_argument("--skew", type=float, default=0.0, metavar="ALPHA",
                    help="Zipf(ALPHA)-skewed partition->device ownership "
                         "(0 = uniform round-robin)")
    ap.add_argument("--cache", action="store_true",
                    help="shared content-addressed feature cache")
    ap.add_argument("--cache-mb", type=int, default=256,
                    help="cache memory-tier bound in MB (default 256)")
    ap.add_argument("--spill-devices", type=int, default=0,
                    help="spill tier on K simulated devices (0 = none)")
    ap.add_argument("--dup-factor", type=int, default=1, metavar="D",
                    help="sample-level dedup: each session's sparse block "
                         "repeats D times; partitions stage as unique "
                         "blocks + refs (default 1 = classic layout)")
    ap.add_argument("--dup-pool", type=int, default=16, metavar="P",
                    help="dataset-level shared block pool size under "
                         "--dup-factor (cross-partition/tenant overlap; "
                         "default 16)")
    ap.add_argument("--megabatch", type=int, default=1, metavar="K",
                    help="coalesce up to K same-job claims into one "
                         "megabatched kernel launch (default 1)")
    ap.add_argument("--autotune", action="store_true",
                    help="tune megabatch K online per job (--megabatch "
                         "caps the ladder)")
    ap.add_argument("--lookahead", type=int, default=1, metavar="D",
                    help="staged-chunk lookahead window depth (default 1 = "
                         "classic double buffer)")
    ap.add_argument("--no-prewarm", action="store_true",
                    help="disable cache pre-warm leases over the lookahead "
                         "peek window")
    ap.add_argument("--no-pipeline", action="store_true",
                    help="disable the zero-stall worker path (megabatching "
                         "+ read/compute overlap); legacy serial produces")
    ap.add_argument("--kill", action="append", metavar="WID@N",
                    help="crash-simulate pool worker WID after N total "
                         "delivered batches (repeatable)")
    ap.add_argument("--restart-after", type=int, default=None, metavar="N",
                    help="checkpoint + tear down + resume the whole service "
                         "after N total delivered batches")
    ap.add_argument("--autoscale", default=None, metavar="MIN:MAX",
                    help="run the backlog-driven autoscaler between MIN and "
                         "MAX workers")
    ap.add_argument("--autoscale-interval", type=float, default=0.05,
                    metavar="S", help="autoscaler evaluation period (s)")
    ap.add_argument("--io-faults", default=None, metavar="SPEC",
                    help="seeded I/O fault injection into every store "
                         "(transient=P,corrupt=P,spill=P,slow=P[:S],"
                         "offline=DEV@N,seed=K)")
    ap.add_argument("--io-retries", type=int, default=3, metavar="N",
                    help="per-partition retry budget before quarantine "
                         "(default 3)")
    ap.add_argument("--io-backoff-ms", type=float, default=10.0, metavar="MS",
                    help="base retry backoff in ms, doubled per attempt "
                         "(default 10)")
    ap.add_argument("--verify", action="store_true",
                    help="recompute every delivered batch solo and assert "
                         "bitwise-identical, complete output")
    ap.add_argument("--events-out", default=None, metavar="PATH",
                    help="write the structured event stream as JSON")
    ap.add_argument("--device", default=None,
                    help="device of the engines and the feature cache "
                         "(default cuda; cpu runs the plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    workers = args.workers if args.workers is not None else args.jobs + 1
    kills = [parse_kill_spec(s) for s in (args.kill or [])]
    scale_bounds = None
    if args.autoscale:
        lo, _, hi = args.autoscale.partition(":")
        scale_bounds = (int(lo), int(hi))
    chaos = bool(kills) or args.restart_after is not None
    cost_model = ContentionAwareCostModel()
    fleet = (DeviceFleet.from_cost_model(args.devices, cost_model)
             if args.devices > 0 else None)
    # ONE seeded injector shared by every tenant's store: the offline
    # trigger counts reads pool-wide, exactly like a real device dying
    # under everyone at once
    injector = parse_iofault_spec(args.io_faults) if args.io_faults else None
    owner_map = None
    if fleet is not None and args.skew > 0:
        # one shared map: every tenant's partition p lives on the same hot
        # device, so skew compounds across tenants instead of averaging out
        owner_map = zipf_owner_map(args.partitions, args.devices, args.skew)
    cache = None
    if args.cache:
        spill_fleet = (fleet if fleet is not None
                       and args.spill_devices == len(fleet) else None)
        spill = (default_spill_store(args.spill_devices, fleet=spill_fleet)
                 if args.spill_devices > 0 else None)
        cache = FeatureCache(args.cache_mb << 20, spill=spill, device=device)

    # the chaos drills' checkpoints, removed when main returns
    ckpt_tmp = (tempfile.TemporaryDirectory(prefix="presto-ckpt-")
                if chaos else None)
    ckpt_dir = ckpt_tmp.name if ckpt_tmp is not None else None
    jobspecs, job_specs_ts, stores = [], {}, {}
    rms = itertools.cycle(args.rm)
    if args.dup_factor > 1:
        assert args.rows % args.dup_factor == 0 and (
            args.rows // args.dup_factor) % 32 == 0, (
            f"--dup-factor {args.dup_factor}: rows/D must be a multiple of "
            f"32 (got {args.rows} rows)")
    for j in range(args.jobs):
        rm = next(rms)
        rcfg = get_recsys(rm, reduced=args.reduced)
        data_cfg = rcfg.data
        if args.dup_factor > 1:
            data_cfg = dataclasses.replace(
                data_cfg, dup_factor=args.dup_factor, dup_pool=args.dup_pool)
        src = SyntheticRecSysSource(data_cfg, rows=args.rows)
        spec = TransformSpec.from_source(src)
        store = PartitionedStore(
            args.partitions, num_devices=args.devices or 4, source=src,
            fleet=fleet, owner_map=owner_map, fault_injector=injector)
        name = f"{rm}-job{j}"
        job = JobSpec(
            name=name,
            partitions=range(args.partitions),
            spec=spec,
            store=store,
            placement=args.placement,
            target_samples_per_s=args.qos,
            units=args.units,
            megabatch=args.megabatch,
            autotune=args.autotune,
            lookahead=args.lookahead,
            prewarm=not args.no_prewarm,
            checkpoint_path=(os.path.join(ckpt_dir, f"{name}.json")
                             if ckpt_dir else None),
            checkpoint_every=4,
            io_retries=args.io_retries,
            io_backoff_s=args.io_backoff_ms / 1e3,
            device=device,
        )
        jobspecs.append(job)
        job_specs_ts[name] = spec
        stores[name] = store

    def make_service():
        return PreprocessingService(
            num_workers=workers, cache=cache, devices=fleet,
            cost_model=cost_model, pipeline=not args.no_pipeline)

    print(f"pool: {workers} workers serving {args.jobs} jobs "
          f"({args.partitions} x {args.rows}-row partitions each, "
          f"placement={args.placement}, device={device})")
    if chaos:
        directives = [f"kill {w}@{n}" for n, w in kills]
        if args.restart_after is not None:
            directives.append(f"restart@{args.restart_after}")
        print(f"chaos: {', '.join(directives)}")
    if injector is not None:
        print(f"io-faults: {args.io_faults} (retry budget "
              f"{args.io_retries}, backoff {args.io_backoff_ms}ms)")

    counter = _Counter()
    results = {job.name: {} for job in jobspecs}
    gots = {job.name: {} for job in jobspecs}
    final_sessions = {}
    ckpts = {}
    all_events, event_counts = [], {}
    restart_pending = args.restart_after
    wall0 = time.perf_counter()
    phase = 0
    while True:
        phase += 1
        service = make_service()
        if injector is not None:
            # each incarnation gets the injected-fault events in ITS stream
            injector.events = service.events
        scaler = None
        if scale_bounds is not None:
            scaler = Autoscaler(service, AutoscalePolicy(
                min_workers=scale_bounds[0], max_workers=scale_bounds[1]))
        sessions, threads = {}, []
        for job in jobspecs:
            if job.name in final_sessions:
                continue  # finished in an earlier incarnation
            session = service.submit(job, resume_from=ckpts.pop(job.name, None))
            sessions[job.name] = session
            threads.append(threading.Thread(
                target=_consume,
                args=(session, args.consume_ms / 1e3, results[job.name],
                      gots[job.name], counter)))

        restart_requested = threading.Event()

        def do_restart(sessions=sessions, service=service):
            # exact frontier at teardown: anything delivered after this
            # snapshot is simply re-produced on resume (bitwise identical)
            for name, session in sessions.items():
                if not session.stats().done:
                    ckpts[name] = session.checkpoint()
            restart_requested.set()
            service.close()

        monitor = None
        if (kills and phase == 1) or restart_pending is not None:
            monitor = threading.Thread(
                target=_chaos_monitor,
                args=(service, counter, kills if phase == 1 else [],
                      restart_pending, do_restart),
                daemon=True)
        for t in threads:
            t.start()
        if scaler is not None:
            scaler.start(args.autoscale_interval)
        if monitor is not None:
            monitor.start()
        for t in threads:
            t.join()
        if scaler is not None:
            scaler.stop()
        for name, session in sessions.items():
            st = session.stats()
            if st.done:
                final_sessions[name] = session
            elif not restart_requested.is_set():
                quarantined = (f" ({st.quarantined} partition(s) "
                               f"quarantined)" if st.quarantined else "")
                raise RuntimeError(
                    f"job {name} interrupted without a requested restart"
                    f"{quarantined}: {results[name].get('interrupted')}")
        if not service.closed:
            service.close()
        all_events.extend(service.events.to_dicts())
        for kind, n in service.events.counts().items():
            event_counts[kind] = event_counts.get(kind, 0) + n
        if restart_requested.is_set():
            restart_pending = None  # the drill restarts at most once
            remaining = [j.name for j in jobspecs
                         if j.name not in final_sessions]
            print(f"chaos: resuming {len(remaining)} checkpointed job(s) on "
                  f"a fresh service")
            continue
        break
    wall = time.perf_counter() - wall0

    print(f"\n{'job':<12} {'batches':>7} {'rows/s':>9} {'util':>6} "
          f"{'starve':>7} {'reissue':>7} {'dupes':>6} {'hits':>5} "
          f"{'blk':>7} {'fallbk':>6} {'tunedK':>6} {'staged':>8} "
          f"{'prewrm':>6} {'produce':>8} {'stage':>7} {'dwait':>7} {'share/demand':>13}")
    for job in jobspecs:
        st = final_sessions[job.name].stats()
        result = results[job.name]
        util = result["busy_s"] / max(result["wall_s"], 1e-9)
        assert st.done and not st.cancelled, f"job {st.job} did not drain"
        if not chaos:
            assert result["batches"] == st.total
        staged = (f"{st.staged_bytes_peak / 1e6:.1f}M"
                  if st.staged_bytes_peak else "-")
        # blk: batches assembled from the shared block tier / unique blocks
        # this tenant published into it (only dedup'd cacheable jobs move it)
        blk = (f"{st.block_hits}/{st.blocks_published}"
               if args.dup_factor > 1 else "-")
        print(f"{st.job:<12} {result['batches']:>7} "
              f"{st.achieved_samples_per_s:>9.0f} "
              f"{util:>6.2f} {st.starvation:>7.2f} {st.reissues:>7} "
              f"{st.duplicates_dropped:>6} {st.cache_hits:>5} "
              f"{blk:>7} {st.host_fallbacks:>6} {st.tuned_k:>6} "
              f"{staged:>8} {st.prewarm_hits:>6} "
              # worker seconds: produce, of which staging and deliver wait
              f"{st.produce_time_s:>8.3f} {st.stage_time_s:>7.3f} "
              f"{st.deliver_wait_s:>7.3f} "
              f"{st.share:>7}/{st.effective_demand_units}")
    total_rows = sum(s.stats().rows_delivered for s in final_sessions.values())
    print(f"\naggregate: {total_rows} rows in {wall:.1f}s "
          f"({total_rows / max(wall, 1e-9):.0f} rows/s across tenants)")
    if args.dup_factor > 1:
        moved = sum(s.bytes_read for s in stores.values())
        logical = sum(s.logical_bytes_read for s in stores.values())
        if logical:
            print(f"dedup: moved {moved / 1e6:.2f}MB of "
                  f"{logical / 1e6:.2f}MB logical "
                  f"({(logical - moved) / logical * 100:.1f}% stayed on "
                  f"storage at dup-factor {args.dup_factor})")

    if args.verify:
        verify_delivered(jobspecs, gots, stores, job_specs_ts, args.partitions,
                         args.placement, device)

    if fleet is not None:
        print(f"\n{'device':<9} {'claims':>7} {'queue':>6} {'max-infl':>9} "
              f"{'fallback':>9} {'stream MB':>10} {'spill MB':>9} "
              f"{'busy ms':>8}")
        for snap in fleet.utilization():
            print(f"dev{snap['device']:03d}   {snap['isp_claims']:>7} "
                  f"{snap['queue_depth']:>6} {snap['max_inflight']:>9} "
                  f"{snap['host_fallbacks']:>9} "
                  f"{snap['bytes_streamed'] / 1e6:>10.2f} "
                  f"{snap['spill_bytes'] / 1e6:>9.2f} "
                  f"{snap['busy_s'] * 1e3:>8.2f}")
        print(f"{'host':<9} {fleet.host_produces:>7} {'-':>6} {'-':>9} "
              f"{'-':>9} {fleet.host_link_bytes / 1e6:>10.2f} {'-':>9} "
              f"{fleet.host_busy_s * 1e3:>8.2f}")
        if args.skew > 0:
            total_fallbacks = sum(d.host_fallbacks for d in fleet)
            print(f"skew={args.skew}: {total_fallbacks} claim(s) fell back "
                  f"to the host path")
    if cache is not None:
        cs = cache.stats()
        print(f"cache: hits={cs.hits} follows={cs.follows} misses={cs.misses} "
              f"hit_rate={cs.hit_rate:.2f} entries={cs.entries} "
              f"resident={cs.resident_bytes / 1e6:.1f}MB "
              f"spilled={cs.spilled_entries} ({cs.spilled_bytes / 1e6:.1f}MB, "
              f"{cs.spill_io_s * 1e3:.2f}ms modeled I/O)")

    if injector is not None:
        stats = [s.stats() for s in final_sessions.values()]
        tot_r = sum(s.retries for s in stats)
        tot_f = sum(s.failovers for s in stats)
        tot_q = sum(s.quarantined for s in stats)
        injected = " ".join(
            f"{k}={n}" for k, n in sorted(injector.summary().items()) if n)
        print(f"io-faults: injected[{injected or 'none'}] "
              f"retries={tot_r} failovers={tot_f} quarantined={tot_q}")
        if tot_q:
            raise SystemExit(
                f"io-faults: {tot_q} partition(s) ended quarantined")

    if event_counts:
        summary = " ".join(f"{k}={n}" for k, n in sorted(event_counts.items()))
        print(f"\nevents: {summary}")
        for ev in all_events[-8:]:
            data = " ".join(f"{k}={v}" for k, v in ev["data"].items())
            print(f"  [{ev['seq']:>4}] {ev['kind']:<14} {data}")
    if args.events_out:
        with open(args.events_out, "w") as f:
            json.dump(all_events, f, indent=2, default=str)
        print(f"events: wrote {len(all_events)} event(s) to {args.events_out}")
    if ckpt_tmp is not None:
        ckpt_tmp.cleanup()
    return {job.name: final_sessions[job.name].stats() for job in jobspecs}


if __name__ == "__main__":
    main()
