"""Matrices a step through the program's eigh, on every route: the sum of
the program tracer's ``eigh.matrices.<route>`` counters (``converged``,
``xla``, ``jacobi``) over the timed window's steps (0 where the tracer ran
and counted none). None where the run has no program tracer."""

PREFIX = "eigh.matrices."


def read(ctx):
    program = ctx.get("program")
    if program is None:
        return None
    n = sum(v for k, v in program["counters"].items() if k.startswith(PREFIX))
    return n / ctx["steps"]
