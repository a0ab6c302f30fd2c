"""Fault handling of the port (counterpart of ``unicore_tpu/resilience``)."""
