"""Port of ``basd_tpu/utils``."""
