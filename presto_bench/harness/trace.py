"""Reading a ``torch.profiler`` Chrome trace into the numbers the per-layer
metrics need.

The profiler writes one JSON object with ``traceEvents``.  Complete events
(``"ph": "X"``) carry a category: device work is ``kernel``, ``gpu_memcpy``
or ``gpu_memset``; host work is ``cpu_op`` and ``user_annotation`` (a
``torch.profiler.record_function`` range such as the program's ``adamw``),
and the launch calls are ``cuda_runtime`` or ``cuda_driver``.  A device
event and the call that launched it share ``args.correlation``.  A device
event is *under* a host range when its launch call lies inside that range
on the same host thread.  Times are in microseconds; everything this module
returns is in seconds.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Callable, Dict, Iterable, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
RANGE_CATS = ("cpu_op", "user_annotation")


class TraceView:
    """The device events of a traced stretch, their launches and the host
    ranges around them."""

    def __init__(self, events: Iterable[dict]):
        self.device: List[Tuple[str, str, float, float, Optional[int]]] = []
        launches: Dict[int, Tuple[object, float]] = {}
        ranges = defaultdict(list)
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = str(e.get("cat", "")).lower()
            ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
            args = e.get("args") or {}
            if cat in DEVICE_CATS:
                self.device.append((e.get("name", ""), cat, ts, dur, args.get("correlation")))
            elif cat in LAUNCH_CATS and args.get("correlation") is not None:
                launches[args["correlation"]] = ((e.get("pid"), e.get("tid")), ts)
            elif cat in RANGE_CATS:
                ranges[(e.get("pid"), e.get("tid"))].append((ts, ts + dur, e.get("name", "")))
        self.device.sort(key=lambda d: d[2])
        self.launches = launches
        self.ranges = dict(ranges)
        self._encl: Optional[Dict[int, List[str]]] = None

    @classmethod
    def load(cls, path: str) -> "TraceView":
        with open(path) as f:
            data = json.load(f)
        return cls(data["traceEvents"] if isinstance(data, dict) else data)

    # -- device time -----------------------------------------------------------

    def busy_s(self, cats: Tuple[str, ...] = DEVICE_CATS,
               match: Optional[Callable[[str], bool]] = None) -> float:
        """Seconds in which at least one device event of `cats` (and whose
        name `match` accepts) ran: the union of their intervals."""
        spans = [(ts, ts + dur) for name, cat, ts, dur, _ in self.device
                 if cat in cats and (match is None or match(name))]
        return _union(spans) / 1e6

    def time_s(self, match: Callable[[str], bool], cats: Tuple[str, ...] = DEVICE_CATS) -> float:
        """Summed device seconds of the events of `cats` whose name `match`
        accepts."""
        return sum(dur for name, cat, _, dur, _ in self.device
                   if cat in cats and match(name)) / 1e6

    def count(self, match: Callable[[str], bool], cats: Tuple[str, ...] = DEVICE_CATS) -> int:
        return sum(1 for name, cat, *_ in self.device if cat in cats and match(name))

    def _enclosing(self) -> Dict[int, List[str]]:
        """Each launch's enclosing host ranges, outermost first, by
        correlation: one sweep a thread over its ranges and launches."""
        if self._encl is not None:
            return self._encl
        by_thread = defaultdict(list)
        for corr, (key, ts) in self.launches.items():
            by_thread[key].append((ts, corr))
        out: Dict[int, List[str]] = {}
        for key, calls in by_thread.items():
            rs = sorted(self.ranges.get(key, ()), key=lambda r: (r[0], -r[1]))
            stack: List[Tuple[float, float, str]] = []
            ri = 0
            for ts, corr in sorted(calls):
                while ri < len(rs) and rs[ri][0] <= ts:
                    while stack and stack[-1][1] < rs[ri][0]:
                        stack.pop()
                    stack.append(rs[ri])
                    ri += 1
                while stack and stack[-1][1] < ts:
                    stack.pop()
                out[corr] = [name for _, end, name in stack if end >= ts]
        self._encl = out
        return out

    def time_under_s(self, range_match: Callable[[str], bool]) -> float:
        """Summed device seconds of the events launched inside a host range
        whose name `range_match` accepts (on the launching thread)."""
        total, encl = 0.0, self._enclosing()
        for _, _, _, dur, corr in self.device:
            if any(range_match(n) for n in encl.get(corr, ())):
                total += dur
        return total / 1e6

    # -- summaries -----------------------------------------------------------------

    def top_ops(self, n: int = 10) -> List[List]:
        """The `n` device operations that took most time: [name, seconds]."""
        by = defaultdict(float)
        for name, _, _, dur, _ in self.device:
            by[name[:120]] += dur / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The longest idle stretches of the device, summed by what the host
        was doing: the innermost host range around the launch of the device
        event that ended the gap ("no launch" where it has none)."""
        by, encl = defaultdict(float), self._enclosing()
        end = None
        for name, _, ts, dur, corr in self.device:
            if end is not None and ts > end:
                inner = encl.get(corr, [])
                by[(inner[-1] if inner else "no launch")[:120]] += (ts - end) / 1e6
            end = ts + dur if end is None else max(end, ts + dur)
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def _union(spans: List[Tuple[float, float]]) -> float:
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total
