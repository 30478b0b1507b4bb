"""sdrreceiver_tpu_torch — the receiver ported to PyTorch and CUDA (Hopper).

A second package beside ``sdrreceiver_tpu`` (the JAX reference).  It mirrors
that package's module names so each counterpart is easy to find, imports
``torch`` and numpy only, and never ``jax``: the machine with the GPU has no
JAX installed.

Subpackages:
  kernels  DSP functions on tensors (ingest, DC, NCO, FIR, half-band, USB)
           plus the host-side filter design
  cuda     wrappers around the hand-written CUDA kernels (``csrc/``), each
           with its plain PyTorch version, and the nvcc build
  graph    ini config -> ReceiverPlan -> CompiledReceiver (one step per
           ingest block)
  io       test-signal synthesis
  flagship the 27-channel benchmark configuration
"""

__version__ = "0.1.0"
