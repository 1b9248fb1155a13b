"""Data parallelism (counterpart of ``basd_tpu/parallel``):
``parallel.mesh``."""
