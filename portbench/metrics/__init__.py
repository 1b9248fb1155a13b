"""One reader a per-layer metric, found by the metric's name: ``read(ctx)``
returns the metric's value, or None where its run gives it nothing to read.

``ctx``: ``program`` (the program tracer's ``summary()`` over the timed
window: its spans' device ms and its counters), ``steps`` and ``event_s``
(the timed window's steps and its device time from the first step's start
to the last one's end), ``profile`` (the profiled sub-window after it:
``trace``, ``steps``, ``wall_s`` and the hand-written kernels'
``launches``), ``busy_ms`` (device-busy ms a profiled step), ``shape``
(``counts.StepShape``), ``counts``, ``bench_dir``, ``log``."""
