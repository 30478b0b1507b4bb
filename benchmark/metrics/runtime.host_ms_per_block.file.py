"""runtime (``core/runtime.run_pipeline``), closed loop: the median over the
window's blocks outside the profiled slice of ``PipelineMetrics.block_seconds``,
the host's time to upload a block, enqueue its step and publish the
previous block, in ms."""

import statistics


def read(t):
    if t.kind != "file" or not t.block_seconds:
        return None
    return statistics.median(t.block_seconds) * 1e3
