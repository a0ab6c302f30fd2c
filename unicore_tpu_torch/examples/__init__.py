"""Example models of the port (counterpart of ``examples/``)."""
