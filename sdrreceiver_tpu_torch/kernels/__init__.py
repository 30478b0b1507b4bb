"""DSP functions on tensors and host-side filter design (ports of
``sdrreceiver_tpu.kernels``)."""
