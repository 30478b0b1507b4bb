"""sdrreceiver_tpu_torch — the receiver ported to PyTorch and CUDA (Hopper).

A second package beside ``sdrreceiver_tpu`` (the JAX reference).  It mirrors
that package's module names so each counterpart is easy to find, imports
``torch`` and numpy only, and never ``jax``: the machine with the GPU has no
JAX installed.

Subpackages:
  kernels  DSP functions on tensors (ingest, DC, NCO, FIR, half-band, late
           /5 /6, overlap-save FFT, USB, IQ compression) plus the host-side
           filter design
  cuda     wrappers around the hand-written CUDA kernels (``csrc/``), each
           with its plain PyTorch version, and the nvcc build
  graph    ini config -> ReceiverPlan -> CompiledReceiver (one step per
           ingest block)
  core     streaming helpers, checkpoints, the host pipeline runner
  obs      pipeline metrics, the plan cost model, the spectrum scope and
           the live, switchable scope
  io       IQ files, test-signal synthesis, WAV output, ZMQ egress, the
           rtl_tcp client, the librtlsdr binding, the native block ring
  cli      ``python -m sdrreceiver_tpu_torch`` (plan, synth, process-file,
           run, devices, bench) and the UDP control socket
  flagship the configurations the port is driven and measured with
"""

__version__ = "0.3.0"
