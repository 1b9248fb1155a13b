"""Device time a step of the selector (``select_and_mix``: the f32 Grams,
the stacked and principal-angle eighs or K8, the MP ranks and the K6 mix):
the program tracer's ``selector`` span, over the timed window's steps. None
where the run has no program tracer."""

from portbench.metrics._program import span_ms


def read(ctx):
    return span_ms(ctx, "selector")
