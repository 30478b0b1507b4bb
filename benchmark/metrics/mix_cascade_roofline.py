"""kernels (``cuda/frontend.MixCascade`` -> ``csrc/mix_cascade.cu``): the least
time of every mix + cascade site the plan has at the cell's block
(``harness/roofline.py``) over the kernel's device time per step in the
profiled slice, in %."""

from harness.roofline import mix_cascade_bound_us


def read(t):
    us, n = t.row_us("mix_cascade")
    bound = mix_cascade_bound_us(t.cfg, t.block)
    if t.kind != "file" or n == 0 or t.steps <= 0 or bound is None:
        return None
    return 100.0 * bound / (us / t.steps)
