"""runtime (``core/runtime.run_pipeline`` under ``run``): the median over the
window's blocks outside the profiled slice of the seconds ``run_pipeline``
records per block (a wrapper on ``PipelineMetrics.record_block``), in ms.
It leaves out the wait for the next block."""

import statistics


def read(t):
    if t.kind != "live" or not t.block_seconds:
        return None
    return statistics.median(t.block_seconds) * 1e3
