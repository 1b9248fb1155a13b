"""Device time a step of the backward (``torch.autograd.grad``: K3b and K4b
with their recomputed forwards, the eigh, K7 and K6 backward): the program
tracer's ``backward`` span, over the timed window's steps. None where the
run has no program tracer."""

from portbench.metrics._program import span_ms


def read(ctx):
    return span_ms(ctx, "backward")
