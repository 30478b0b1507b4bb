"""Streaming substrate, checkpoints and the host pipeline runner (ports of
``sdrreceiver_tpu.core``)."""
