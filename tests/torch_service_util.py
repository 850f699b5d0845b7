"""Shared helpers of the port's service tests: bounded waits and bitwise
batch comparison.  This container has no ``pytest-timeout``, so every wait
on a session, a future or a thread goes through ``bounded`` or takes a
timeout, and a hang fails its test instead of the run."""

import threading

import torch

WAIT_S = 60.0  # bound on every wait


def bounded(fn, *args, timeout=WAIT_S, **kwargs):
    """``fn(*args, **kwargs)`` on a thread, failing the test if it has not
    returned within `timeout` seconds; re-raises what it raised."""
    box = {}

    def run():
        try:
            box["out"] = fn(*args, **kwargs)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            box["exc"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), f"{getattr(fn, '__name__', fn)} still running after {timeout} s"
    if "exc" in box:
        raise box["exc"]
    return box.get("out")


def collect(session) -> dict:
    """A session's whole stream as ``{pid: batch}``, bounded."""
    return bounded(lambda: {pid: mb for pid, mb in session})


def join_all(threads) -> None:
    for t in threads:
        t.join(WAIT_S)
        assert not t.is_alive(), f"{t.name} still running after {WAIT_S} s"


def assert_bitwise(got: dict, want: dict, what: str = "") -> None:
    """The same pids, and every key of every batch bitwise: dtype, shape and
    bits, NaN payloads and signed zeros included (floats compared as their
    int32 words)."""
    assert sorted(got) == sorted(want), what
    for pid, batch in got.items():
        assert sorted(batch) == sorted(want[pid]), f"{what} pid={pid}"
        for key, w in want[pid].items():
            g = batch[key]
            assert g.dtype == w.dtype and g.shape == w.shape, f"{what} pid={pid} key={key}"
            if g.is_floating_point():
                g, w = g.view(torch.int32), w.view(torch.int32)
            assert torch.equal(g, w), f"{what} pid={pid} key={key} diverged"
