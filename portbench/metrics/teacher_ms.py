"""Device time a step of the trainer's teacher_forward (models/registry.py:teacher_extract; K1, K2, K5a): CUDA events around each
call, summed over the timed window, over its steps."""


def read(ctx):
    return ctx["spans_ms"]["teacher"] / ctx["steps"]
