"""The benchmark of ``basd_tpu_torch``, the PyTorch and CUDA port of the
BASD distillation train step: ``run.py`` runs one cell of
``BENCHMARK.json`` once; ``reference/`` is the plain PyTorch reference
that decides ``correct``; ``counts/`` the FLOP and byte arithmetic;
``metrics/`` one reader a per-layer metric."""
