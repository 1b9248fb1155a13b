"""Device time a step of the optimizer (``training/schedulefree.py:update``):
the program tracer's ``update`` span, over the timed window's steps. None
where the run has no program tracer."""

from portbench.metrics._program import span_ms


def read(ctx):
    return span_ms(ctx, "update")
