"""Idle device time a profiled step that the library eigh's host-driven
sweeps expose: the host intervals of the program's ``basd.eigh``
annotations in the profiled steps' trace, intersected with the gaps
between the merged device intervals (``Trace.busy()``). None where the
trace holds no such annotation (a run without the program tracer)."""

import bisect

ANNOTATION = "basd.eigh"


def idle_within(merged, spans):
    """ns of the gaps between ``merged`` (sorted, disjoint [start, end]
    device intervals) that the (start, end) ``spans`` cover."""
    gaps = [(a[1], b[0]) for a, b in zip(merged, merged[1:])]
    ends = [e for _, e in gaps]
    total = 0
    for s, e in spans:
        i = bisect.bisect_right(ends, s)
        while i < len(gaps) and gaps[i][0] < e:
            total += max(0, min(e, gaps[i][1]) - max(s, gaps[i][0]))
            i += 1
    return total


def read(ctx):
    prof = ctx["profile"]
    tr = prof["trace"]
    spans = [(s, e) for s, e, name in tr.annotations if name == ANNOTATION]
    if not spans:
        return None
    _, merged = tr.busy()
    return idle_within(merged, spans) / 1e6 / prof["steps"]
