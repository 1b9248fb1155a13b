"""Device time a step of the teacher's forward
(``models/registry.py:teacher_extract``; K1, K2, K5a): the program
tracer's ``teacher`` span, over the timed window's steps. None where the
run has no program tracer."""

from portbench.metrics._program import span_ms


def read(ctx):
    return span_ms(ctx, "teacher")
