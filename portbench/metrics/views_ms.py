"""Device time a step of the trainer's make_views (data/augment.py: RRC, TAW with K9, MixUp/CutMix): CUDA events around each
call, summed over the timed window, over its steps."""


def read(ctx):
    return ctx["spans_ms"]["views"] / ctx["steps"]
