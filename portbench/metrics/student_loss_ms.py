"""Device time a step of the trainer's loss_and_grads (the student's forward and backward with K3, K4, K5 and the BASD loss with K6, K7, the eighs): CUDA events around each
call, summed over the timed window, over its steps."""


def read(ctx):
    return ctx["spans_ms"]["student_loss"] / ctx["steps"]
