"""step (``graph/compiler.CompiledReceiver`` replaying ``graph/cudagraph.StepGraphs``):
device time per step over the profiled slice of the window: every CUDA row
(kernels, copies, memsets) the profiler saw, over the steps in the slice."""


def read(t):
    if t.kind != "file" or t.steps <= 0 or not t.rows:
        return None
    return sum(v[0] for v in t.rows.values()) / t.steps
