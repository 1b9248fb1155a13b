"""What the readers of the program tracer share: ``ctx["program"]`` is
``basd_tpu_torch.utils.trace.summary()`` over the timed window, absent
where the run has no program tracer."""


def span_ms(ctx, name):
    """The span's device ms a step of the timed window, or None."""
    span = (ctx.get("program") or {}).get("spans", {}).get(name)
    if span is None:
        return None
    return span["device_ms"] / ctx["steps"]
