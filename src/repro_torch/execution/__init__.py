"""Plan execution on synthetic data (``executor``)."""
