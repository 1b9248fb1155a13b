"""The program's tracer: named spans at the train step's layer boundaries
and plain-integer counters, off by default.

    from basd_tpu_torch.utils import trace

    with trace.span("selector"):
        ...
    trace.count("eigh.matrices.xla", 64)

Off, ``span`` costs one test of a module-level flag and returns a shared
no-op context, and ``count`` the same test: nothing is recorded, no CUDA
event is made and no profiler range is entered. On (``enable()``), each
span records its name, its parent span, the step it belongs to (the number
of the enclosing ``step`` span, which every span of one train step
shares), its host start and end (``time.perf_counter_ns``) and, where the
process has initialised CUDA, a pair of timing events on the current
stream (none for a span opened with ``device=False``, such as the host's
wait for data). It also opens ``torch.profiler.record_function("basd.<name>")``,
so that under a profiler the span is a user annotation on the clock of
the device's activity.

Spans are opened from the thread that calls ``Trainer.step``: one
process-wide stack keeps the parents. No span is opened inside an autograd
backward, which runs on another thread on the card.

Memory stays bounded without a synchronisation: when a ``step`` span
closes, the records whose end event has completed are folded into running
sums and their events reused. Only ``summary()`` synchronises.
"""

from __future__ import annotations

import contextlib
import time

import torch

STEP = "step"
PREFIX = "basd."

_on = False
_NOOP = contextlib.nullcontext()
_stack: list = []  # names of the open spans, innermost last
_pending: list = []  # closed records not yet folded, in closing order
_free: list = []  # timing events of folded records, for reuse
_sums: dict = {}  # name -> running sums
_counters: dict = {}
_step = 0  # number of the last ``step`` span opened
_events = False


def _new_event():
    return torch.cuda.Event(enable_timing=True)


def _event():
    return _free.pop() if _free else _new_event()


class _Span:
    __slots__ = ("name", "device", "parent", "step", "t0", "start", "end",
                 "rf")

    def __init__(self, name: str, device: bool):
        self.name = name
        self.device = device

    def __enter__(self):
        global _step
        if self.name == STEP:
            _step += 1
        self.parent = _stack[-1] if _stack else None
        self.step = _step
        _stack.append(self.name)
        self.rf = torch.profiler.record_function(PREFIX + self.name)
        self.rf.__enter__()
        self.start = self.end = None
        if _events and self.device:
            self.start = _event()
            self.start.record()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        host_ns = time.perf_counter_ns() - self.t0
        if self.start is not None:
            self.end = _event()
            self.end.record()
        self.rf.__exit__(*exc)
        _stack.pop()
        _pending.append((self.name, self.parent, self.step, host_ns,
                         self.start, self.end))
        if self.name == STEP:
            _fold(wait=False)
        return False


def span(name: str, device: bool = True):
    """A context timing one call of the layer ``name``; with ``device``
    False, on the host's clock alone (its ``device_ms`` reads 0)."""
    if not _on:
        return _NOOP
    return _Span(name, device)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    if _on:
        _counters[name] = _counters.get(name, 0) + n


def _sum(name: str) -> dict:
    s = _sums.get(name)
    if s is None:
        s = _sums[name] = {"parents": set(), "calls": 0, "steps": 0,
                           "last_step": None, "device_ms": 0.0,
                           "host_ms": 0.0, "child_device_ms": 0.0,
                           "child_host_ms": 0.0}
    return s


def _fold(wait: bool) -> None:
    """Fold the pending records into the sums, in closing order, up to the
    first whose end event has not completed (all of them with ``wait``,
    after a synchronisation). The records close in the order their end
    events were recorded on the stream, so the rest are not complete
    either."""
    if wait and _events and _pending:
        torch.cuda.synchronize()
    done = 0
    for name, parent, step, host_ns, start, end in _pending:
        if end is not None and not end.query():
            break
        device_ms = start.elapsed_time(end) if end is not None else 0.0
        host_ms = host_ns / 1e6
        s = _sum(name)
        s["parents"].add(parent)
        s["calls"] += 1
        if step != s["last_step"]:
            s["steps"] += 1
            s["last_step"] = step
        s["device_ms"] += device_ms
        s["host_ms"] += host_ms
        if parent is not None:
            p = _sum(parent)
            p["child_device_ms"] += device_ms
            p["child_host_ms"] += host_ms
        if end is not None:
            _free.extend((start, end))
        done += 1
    del _pending[:done]


def enable() -> None:
    """Trace from now on (with CUDA events where the process has
    initialised CUDA, which a program on the card has done by the time it
    builds its models)."""
    global _on, _events
    _events = torch.cuda.is_available() and torch.cuda.is_initialized()
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def reset() -> None:
    """Forget every record, sum and counter (open spans still close)."""
    _pending.clear()
    _sums.clear()
    _counters.clear()


def summary() -> dict:
    """Synchronise, fold, and return ``{"spans": {name: {...}}, "counters":
    {...}}``. Each span's entry: ``parents`` (the names of the spans it was
    opened in, None at the root), ``calls``, ``steps`` (the train steps it
    ran in), ``device_ms`` (the sum of its event pairs' elapsed times; 0
    without CUDA), ``host_ms``, and ``self_device_ms`` and
    ``self_host_ms``: its time less what its child spans cover."""
    _fold(wait=True)
    spans = {}
    for name, s in _sums.items():
        if not s["calls"]:
            continue  # a parent still open (or reset away while open)
        spans[name] = {
            "parents": sorted(s["parents"], key=str),
            "calls": s["calls"], "steps": s["steps"],
            "device_ms": s["device_ms"], "host_ms": s["host_ms"],
            "self_device_ms": s["device_ms"] - s["child_device_ms"],
            "self_host_ms": s["host_ms"] - s["child_host_ms"],
        }
    return {"spans": spans, "counters": dict(_counters)}


def per_step(summ: dict) -> dict:
    """A summary's spans and counters a train step (over the ``step``
    span's calls): ``{"steps", "spans": {name: {"calls", "device_ms",
    "host_ms", "self_device_ms"}}, "counters"}``."""
    steps = summ["spans"].get(STEP, {}).get("calls", 0)
    k = max(steps, 1)
    return {
        "steps": steps,
        "spans": {name: {f: s[f] / k for f in ("calls", "device_ms",
                                                "host_ms", "self_device_ms")}
                  for name, s in summ["spans"].items()},
        "counters": {name: v / k for name, v in summ["counters"].items()},
    }
