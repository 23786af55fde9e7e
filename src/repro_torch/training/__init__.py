"""Training substrate: synthetic data pipelines (``data``)."""
