"""IQ recording files, test-signal synthesis, WAV output and ZMQ egress
(numpy-only ports of ``sdrreceiver_tpu.io``)."""
