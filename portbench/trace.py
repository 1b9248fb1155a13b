"""Reading a ``torch.profiler`` trace of the card from its raw kineto
events: the union of device intervals (busy time), device time by kernel
name, and the longest idle gaps named by what the host was doing."""

from __future__ import annotations

from dataclasses import dataclass, field

# the tracer's own buffer activity, which the profiler lists as device time
PROFILER_OVERHEAD = ("Buffer Flush", "Activity Buffer Request")


def _activity(e) -> str:
    """The kineto activity type's name, where this PyTorch gives it."""
    kind = getattr(e, "activity_type", None)
    return str(kind()).lower() if kind is not None else ""


def _t(e):
    """(start, end) of a kineto event in ns."""
    s = e.start_ns()
    return s, s + e.duration_ns()


@dataclass
class Trace:
    device: list = field(default_factory=list)  # (start, end, name, op corr)
    ops: list = field(default_factory=list)  # (start, end, name, corr)
    annotations: list = field(default_factory=list)  # (start, end, name)

    @classmethod
    def from_profile(cls, prof) -> "Trace":
        tr = cls()
        events = prof.profiler.kineto_results.events()
        # the profiler's device-side copies of the host's annotations are
        # ranges, not activity
        marks = {e.name() for e in events
                 if e.is_user_annotation()
                 and not str(e.device_type()).endswith("CUDA")}
        for e in events:
            kind = str(e.device_type())
            start, end = _t(e)
            name = e.name()
            if kind.endswith("CUDA"):
                if (name not in PROFILER_OVERHEAD and name not in marks
                        and not e.is_user_annotation()
                        and "annotation" not in _activity(e)):
                    tr.device.append((start, end, name,
                                      e.linked_correlation_id()))
            elif e.is_user_annotation():
                tr.annotations.append((start, end, name))
            elif (not name.startswith("cu")
                  and name not in PROFILER_OVERHEAD):
                tr.ops.append((start, end, name, e.correlation_id()))
        tr.device.sort()
        tr.ops.sort()
        tr.annotations.sort()
        return tr

    def busy(self) -> tuple:
        """(busy ns, merged intervals): the union of device intervals, so
        overlapping activity counts once."""
        merged = []
        for s, e, *_ in self.device:
            if merged and s <= merged[-1][1]:
                if e > merged[-1][1]:
                    merged[-1][1] = e
            else:
                merged.append([s, e])
        return sum(e - s for s, e in merged), merged

    def by_kernel(self) -> dict:
        """Device ns by kernel (or copy) name."""
        out: dict = {}
        for s, e, name, _ in self.device:
            out[name] = out.get(name, 0) + (e - s)
        return out

    def host_at(self, t: int) -> str:
        """What the host was doing at ``t``: the innermost stage annotation
        and operator running then, as ``stage/op``."""
        def innermost(events):
            best = None
            for ev in events:
                if ev[0] > t:
                    break
                if ev[1] >= t and (best is None
                                   or ev[1] - ev[0] < best[1] - best[0]):
                    best = ev
            return best[2] if best else "-"

        return f"{innermost(self.annotations)}/{innermost(self.ops)}"

    def idle_gaps(self, top: int = 10) -> list:
        """The ``top`` longest gaps between merged device intervals, as
        [what the host was doing at the gap's middle, ns]."""
        _, merged = self.busy()
        gaps = sorted(((b[0] - a[1], a[1], b[0])
                       for a, b in zip(merged, merged[1:])), reverse=True)
        return [[self.host_at((s + e) // 2), g] for g, s, e in gaps[:top]]

