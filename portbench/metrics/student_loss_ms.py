"""Device time a step of ``Trainer.loss_and_grads``: the student's forward
and backward (K3, K4, K5), the BASD loss (K6, K7, the eighs) and, under
data parallelism, the gradients' all-reduce: the program tracer's
``loss_and_grads`` span, over the timed window's steps. None where the run
has no program tracer."""

from portbench.metrics._program import span_ms


def read(ctx):
    return span_ms(ctx, "loss_and_grads")
