"""Math core of the port (counterpart of ``basd_tpu/ops``)."""
