"""Device time a step of the selector's eighs, whatever route takes them
(K8 converged, ``torch.linalg.eigh``, K8 at six sweeps): the program
tracer's ``eigh`` span (``ops/linalg.py:_eigh_impl``), over the timed
window's steps. None where the run has no program tracer."""

from portbench.metrics._program import span_ms


def read(ctx):
    return span_ms(ctx, "eigh")
