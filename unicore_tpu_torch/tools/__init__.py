"""Command-line tools of the port (``python -m unicore_tpu_torch.tools.<name>``)."""
