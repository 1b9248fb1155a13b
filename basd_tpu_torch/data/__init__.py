"""Port of ``basd_tpu/data``."""
