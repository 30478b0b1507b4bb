"""kernels (``cuda/dckernel.DcIngest`` -> ``csrc/dc_ingest.cu``): the kernel's
least time at the cell's block (``harness/roofline.py``) over its device
time per step in the profiled slice, in %."""

from harness.roofline import dc_ingest_bound_us


def read(t):
    us, n = t.row_us("dc_ingest")
    bound = dc_ingest_bound_us(t.cfg, t.block)
    if t.kind != "file" or n == 0 or t.steps <= 0 or bound is None:
        return None
    return 100.0 * bound / (us / t.steps)
