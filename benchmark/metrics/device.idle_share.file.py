"""device: the share of the profiled slice of a closed loop's window in
which the card runs nothing, one less ``busy_s`` over ``window_s`` of the
trace, in %.  The slice is part of the timed window, profiled over CUDA
activity alone."""


def read(t):
    if t.kind != "file" or t.steps <= 0 or t.busy_s <= 0 or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
