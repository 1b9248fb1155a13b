"""Port of ``basd_tpu/evaluation``."""
