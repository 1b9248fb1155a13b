"""Matrices a step through ``torch.linalg.eigh``: the program tracer's
counter ``eigh.matrices.xla`` over the timed window's steps (0 where the
tracer ran and counted none). None where the run has no program tracer."""


def read(ctx):
    program = ctx.get("program")
    if program is None:
        return None
    return program["counters"].get("eigh.matrices.xla", 0) / ctx["steps"]
