"""Runnable end-to-end scenarios of the port (``python -m
repro_torch.examples.<name>``)."""
