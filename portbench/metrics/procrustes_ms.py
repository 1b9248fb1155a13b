"""Device time a step of the relational (Procrustes) loss with K7: the
program tracer's ``procrustes`` span, over the timed window's steps. None
where the run has no program tracer."""

from portbench.metrics._program import span_ms


def read(ctx):
    return span_ms(ctx, "procrustes")
