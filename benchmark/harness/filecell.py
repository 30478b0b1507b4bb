"""A closed loop over a recording: what ``process-file`` users run.

Set-up makes the seeded u8 recording (``traffic["pool_seconds"]`` of it,
held in host memory and played in a cycle), builds the receiver and drives
it through ``traffic["warmup_blocks"]`` blocks with ``run_pipeline``, the
first of which captures the CUDA graph.  The window is a second
``run_pipeline`` call on the same receiver and state, fed blocks until
``seconds`` have passed; each block's int16 audio of every topic reaches a
host sink, which checks its form and keeps a sample of blocks, drawn from
the seed by reservoir sampling, for the reference to check once the window
has closed.  ``throughput_msps`` is the samples of every block the sink
received over the time from the window's first block to its last output.
A traced run wraps the program's layers in host spans during the window
and profiles ``trace_blocks`` of its blocks on the card, from the first
block uploaded after the window's midpoint (``trace.Slice``).
"""

from __future__ import annotations

import contextlib
import math
import statistics
import time

import numpy as np
import torch

from . import check, gen, program
from .trace import DeviceTrace, Slice, TraceData

__all__ = ["run"]


class Sink:
    """The window's host sink: checks every block's outputs, keeps
    ``keep`` of them chosen uniformly from the seed."""

    def __init__(self, shapes: dict[str, int], keep: int, seed: int, first: int):
        self.shapes = shapes
        self.keep = keep
        self.rng = np.random.default_rng([seed, 17])
        self.block = first  # stream index of the next block
        self.received = 0
        self.malformed = 0
        self.t_open = 0.0
        self.per_s: dict[int, int] = {}  # blocks received in each second of the window
        self.sample: list[tuple[int, dict]] = []

    def __call__(self, outs: dict) -> int:
        ok = True
        for key, n in self.shapes.items():
            a = outs.get(key)
            ok = ok and a is not None and a.dtype == np.int16 and a.shape == (n,)
        self.malformed += not ok
        j = self.received
        slot = j if j < self.keep else int(self.rng.integers(0, j + 1))
        if slot < self.keep:
            kept = {k[6:]: np.array(outs[k]) for k in self.shapes if k in outs}
            if j < self.keep:
                self.sample.append((self.block, kept))
            else:
                self.sample[slot] = (self.block, kept)
        self.received += 1
        self.block += 1
        k = int(time.monotonic() - self.t_open)
        self.per_s[k] = self.per_s.get(k, 0) + 1
        return 0


def _medians_ms(t: TraceData) -> dict:
    """The median host ms per block outside and inside the profiled slice."""
    return {k: statistics.median(v) * 1e3 if v else None for k, v in
            (("unprofiled", t.block_seconds), ("profiled", t.block_seconds_profiled))}


def run(cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, fault=None) -> dict:
    """One run; ``fault(rx)`` (tests only) breaks the receiver's timed path."""
    from reference.receiver import Reference, plan

    block, burst = int(traffic["block"]), int(traffic.get("burst", 1))
    fs = int(cfg["sample_rate"])
    n_pool = max(1, math.ceil(traffic["pool_seconds"] * fs / block))
    pool = gen.recording(cfg, block, n_pool, seed, device)
    shapes = {f"audio/{c.topic}": block // c.decimation for c in plan(cfg)[2]}
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    rx = program.receiver(cfg, block, device)
    if fault is not None:
        fault(rx)

    warm = int(traffic["warmup_blocks"])
    _, state = program.run_pipeline(rx, (pool[i % n_pool] for i in range(warm)),
                                    lambda outs: 0, raw_u8=True, return_state=True, burst=burst)
    sync()
    sink = Sink(shapes, int(traffic["check_blocks"]), seed, warm)
    if trace and cuda:
        DeviceTrace.warm()
    part = Slice(traffic["trace_blocks"], profile=cuda) if trace else None
    spans = program.Spans(before={"runtime.upload": part.before_upload}) if trace else None

    def blocks():
        i = warm
        while time.monotonic() < deadline:
            yield pool[i % n_pool]
            i += 1

    with spans or contextlib.nullcontext():
        t_open = sink.t_open = time.monotonic()
        deadline = t_open + seconds
        if part is not None:
            part.t_from = t_open + seconds / 2
        metrics, state = program.run_pipeline(rx, blocks(), sink, raw_u8=True, state=state,
                                              return_state=True, burst=burst)
        sync()
        t_close = time.monotonic()
        if part is not None:
            part.close()
    submitted = metrics.blocks
    out = {
        "attempted": submitted,
        "failed": submitted - sink.received + sink.malformed,
        "e2e": {"throughput_msps": sink.received * block / (t_close - t_open) / 1e6,
                "setup_s": t_open - t_start},
        "memory_peak_bytes": torch.cuda.max_memory_allocated() if cuda else 0,
        "blocks_per_s": [sink.per_s.get(k, 0) for k in range(math.ceil(t_close - t_open))],
    }
    if trace:
        t = TraceData("file", cfg, traffic, block, steps=part.steps)
        ends = [s for s, _ in spans.calls["runtime.record_block"]]
        for at, sec in zip(ends, metrics.block_seconds):
            (t.block_seconds if part.outside(at) else t.block_seconds_profiled).append(sec)
        t.spans = {k: [d for s, d in v if part.outside(s)] for k, v in spans.calls.items()}
        if part.trace is not None:
            part.trace.reduce(t, spans.calls)
        out["trace"] = t
        out["host_ms_per_block"] = _medians_ms(t)
    else:
        out["host_ms_per_block"] = _medians_ms(TraceData(
            "file", cfg, traffic, block, block_seconds=list(metrics.block_seconds)))
    del rx, state, metrics
    if cuda:
        torch.cuda.empty_cache()

    tally = check.Tally()
    tally.malformed = sink.malformed
    ref = Reference(cfg, pool, device)
    for n, got in sink.sample:
        tally.compare(got, ref.audio(n))
    tally.missing = max(0, min(sink.keep, submitted) - len(sink.sample))
    out["numbers"] = tally.numbers()
    return out
