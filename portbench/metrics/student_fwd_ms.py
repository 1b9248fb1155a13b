"""Device time a step of the student's forward under remat (K3a, K4a, K5):
the program tracer's ``student_forward`` span (``ctx["program"]``, the
timed window's ``trace.summary()``), over the window's steps. None where
the run has no program tracer."""

from portbench.metrics._program import span_ms


def read(ctx):
    return span_ms(ctx, "student_forward")
