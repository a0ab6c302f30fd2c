"""Decoder LM of the port (counterpart of ``examples/lm``)."""
