"""Device-busy time a profiled step: the union of the card's kernel and
copy intervals, so that overlapping activity counts once."""


def read(ctx):
    return ctx["busy_ms"]
