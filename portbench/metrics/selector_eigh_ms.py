"""Device time a profiled step of ``torch.linalg.eigh`` in the selector
(the stacked teacher and student eigh and, under the gram backend, the
principal angles'): the activity launched inside ``aten::_linalg_eigh``."""


def read(ctx):
    prof = ctx["profile"]
    ns = prof["trace"].under_op("aten::_linalg_eigh")
    return ns / 1e6 / prof["steps"] if ns else None
