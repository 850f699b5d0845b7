"""step_gap_ms.train: device idle milliseconds between consecutive training
steps, a pair of steps, in the host-and-device traced stretch.  A step is
the program's ``pipeline.step`` span (``TrainingPipeline.run_session``: the
train step and the read of its metrics); a device operation belongs to the
step whose span holds its launch on the launching thread.  For each pair of
consecutive steps of a thread, the idle time is the part of the interval
from the end of the last operation of the first step to the start of the
first operation of the second in which no device operation ran, from any
thread (the pool workers' copies and Transform, whose launches the profiler
does not see, count as busy)."""

import bisect

from presto_bench.harness.trace import _union


def _idle_us(a, b, device):
    """Microseconds of [a, b] in which no device operation ran."""
    return (b - a) - _union([(max(ts, a), min(ts + dur, b)) for _, _, ts, dur, _ in device
                             if ts < b and ts + dur > a])


def read(ctx):
    tv = ctx.get("trace_ranges")
    if tv is None:
        return None
    steps = {key: sorted((s, e) for s, e, name in ranges if name == "pipeline.step")
             for key, ranges in tv.ranges.items()}
    steps = {key: s for key, s in steps.items() if len(s) >= 2}
    if not steps:
        return None
    starts = {key: [s for s, _ in spans] for key, spans in steps.items()}
    first = {key: [None] * len(s) for key, s in steps.items()}
    last = {key: [None] * len(s) for key, s in steps.items()}
    for _, _, ts, dur, corr in tv.device:
        key, t_launch = tv.launches.get(corr, (None, None))
        if key not in steps:
            continue
        i = bisect.bisect_right(starts[key], t_launch) - 1
        if i < 0 or t_launch > steps[key][i][1]:
            continue
        if first[key][i] is None or ts < first[key][i]:
            first[key][i] = ts
        if last[key][i] is None or ts + dur > last[key][i]:
            last[key][i] = ts + dur
    gaps = []
    for key in steps:
        for i in range(len(steps[key]) - 1):
            a, b = last[key][i], first[key][i + 1]
            if a is not None and b is not None:
                gaps.append(_idle_us(a, b, tv.device) if b > a else 0.0)
    return sum(gaps) / len(gaps) / 1e3 if gaps else None
