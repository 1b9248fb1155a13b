"""Device time a step of the trainer's schedulefree.update (training/schedulefree.py): CUDA events around each
call, summed over the timed window, over its steps."""


def read(ctx):
    return ctx["spans_ms"]["update"] / ctx["steps"]
