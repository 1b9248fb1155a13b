"""Device time a step of the teacher's MLP halves (K2, or K2g for a SwiGLU
teacher): the sum of the program tracer's ``teacher_mlp`` spans, one a
teacher block inside ``teacher``, over the timed window's steps. None where
the run has no program tracer or the program no such span."""

from portbench.metrics._program import span_ms


def read(ctx):
    return span_ms(ctx, "teacher_mlp")
