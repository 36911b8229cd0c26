"""Command-line entry points of the port (``python -m autovc_tpu_torch.cli.<name>``)."""
