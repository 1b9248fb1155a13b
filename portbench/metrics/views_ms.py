"""Device time a step of the views (``Trainer.make_views``: RRC, TAW with
K9, MixUp/CutMix): the program tracer's ``views`` span, over the timed
window's steps. None where the run has no program tracer."""

from portbench.metrics._program import span_ms


def read(ctx):
    return span_ms(ctx, "views")
