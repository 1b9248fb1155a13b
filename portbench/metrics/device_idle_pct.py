"""The share of an unprofiled step in which the card is idle: one less the
device-busy time of a profiled step over the timed window's device time a
step, in percent."""


def read(ctx):
    step_ms = ctx["event_s"] * 1e3 / ctx["steps"]
    return 100.0 * (1.0 - ctx["busy_ms"] / step_ms)
