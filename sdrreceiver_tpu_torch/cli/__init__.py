"""Command-line entry points (``python -m sdrreceiver_tpu_torch``)."""
