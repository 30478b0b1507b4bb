"""Host pipeline runner: ingest -> device step -> egress.

Port of ``sdrreceiver_tpu.core.runtime.run_pipeline``.  PyTorch enqueues
CUDA work asynchronously, so the overlap is a software pipeline at most
two deep: upload block N and enqueue its step, publish block N-1 if it was
held, then queue block N's copies to pinned host memory behind a CUDA
event.  Block N is held, and published while the device computes block
N+1, only if the source's next block is already waiting (a recording, a
ring's backlog, a paced source past its next deadline): that overlap keeps
a closed loop at full speed.  Otherwise it is published at once, so a live
block's audio does not wait a block period for the next one
(``published_early``).  Nothing calls ``torch.cuda.synchronize()`` per
block.  On the CPU the same code runs synchronously and the outputs are
the step's own tensors.

Each block's host times are taken once, from ``time.monotonic_ns()``, and
feed both ``PipelineMetrics`` and, while tracing is on (``obs.trace``), the
block's spans and the counter ``runtime.published_early``; on the card
each block's stream work is then bracketed by timing events (the device
timeline).
"""

from __future__ import annotations

import itertools
import time
from typing import Callable, Iterable

import numpy as np
import torch

from ..obs import trace
from ..obs.metrics import PipelineMetrics

__all__ = ["run_pipeline"]


class _Fetched:
    """One step's outputs on their way to the host.  On CUDA each key the
    fetch filter keeps when the step is queued is copied into a fresh
    pinned buffer (``non_blocking``) and an event marks the copies' end;
    the caching host allocator keeps a buffer out of reuse while a callback
    still holds a view of it, so nothing is rewritten before it is
    consumed.  :meth:`numpy` asks the filter again, as the JAX runtime
    filters at publish time: a key it now drops is not delivered, and a key
    it now keeps (a live scope switched in between) is copied then.  With
    ``tr`` (a tracer whose unit in flight has timing events) the copies lie
    between the unit's events 4 and 5, and event 5 is the one waited for."""

    def __init__(self, outputs: dict, keep: Callable[[str], bool], device: torch.device,
                 tr: trace.Tracer | None = None):
        self.outputs = outputs
        self.host: dict[str, torch.Tensor] = {}
        self.event = None
        if device.type == "cuda":
            for k, v in outputs.items():
                if keep(k):
                    self.host[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
        if tr is not None:
            tr.mark(4)
        for k, h in self.host.items():
            h.copy_(outputs[k], non_blocking=True)
        if tr is not None:
            tr.mark(5)
            self.event = tr.timing[5]
        elif device.type == "cuda":
            self.event = torch.cuda.Event()
            self.event.record()

    def numpy(self, keep: Callable[[str], bool]) -> dict[str, np.ndarray]:
        if self.event is not None:
            self.event.synchronize()
        return {k: self.host.get(k, v).cpu().numpy()
                for k, v in self.outputs.items() if keep(k)}


def _upload(rx, block) -> torch.Tensor:
    """A host block (numpy or tensor) -> a tensor on the receiver's device;
    a CUDA upload goes through pinned memory without blocking the host.
    While tracing, the unit's first timing event marks the copy's start,
    after the host's pinning."""
    t = torch.as_tensor(block)
    if rx.device.type == "cuda" and t.device.type == "cpu":
        t = t.pin_memory()
    tr = trace.current()
    if tr is not None and tr.timing is not None:
        tr.mark(0)
    return t if t.device == rx.device else t.to(rx.device, non_blocking=True)


def _step(rx, state, block: torch.Tensor, raw_u8: bool, many: bool):
    """Dispatch on the block's dtype: u8 = raw dongle bytes, f32 =
    interleaved pairs, complex = IQ."""
    if raw_u8 or block.dtype == torch.uint8:
        fn = rx.step_many_u8 if many else rx.step_u8
    elif block.dtype == torch.float32:
        fn = rx.step_many_f32 if many else rx.step_f32
    else:
        fn = rx.step_many_iq if many else rx.step_iq
    return fn(state, block)


def run_pipeline(
    rx,
    blocks: Iterable,
    on_outputs: Callable[[dict[str, np.ndarray]], int] | None = None,
    raw_u8: bool = False,
    max_blocks: int | None = None,
    realtime_fs: int | None = None,
    state=None,
    return_state: bool = False,
    fetch_filter: Callable[[str], bool] | None = None,
    burst: int = 1,
    source_ready: Callable[[], bool] | None = None,
):
    """Drive a CompiledReceiver over a block source.

    Args:
      rx: CompiledReceiver, or a ``dist.ShardedReceiver`` (the same
        entries; on the card a burst replays its mesh's phase graphs of k
        steps).
      blocks: iterable of host (numpy) or device blocks: ``[2T]`` uint8 or
        float32 pairs, or ``[T]`` complex64.
      on_outputs: callback receiving each block's host outputs (numpy,
        after ``split_audio``), in block order; returns messages sent.
      raw_u8: feed every block to the u8 entry.
      max_blocks: stop after N blocks.
      realtime_fs: pace ingestion to this many samples per second.
      state: resume from this state (default: ``rx.init_state()``).
      return_state: also return the final state.
      fetch_filter: per-key predicate; outputs failing it are never copied
        to the host.
      burst: blocks per ``step_many_*`` call (offline throughput; callbacks
        still fire once per block, in order).  Incompatible with
        ``realtime_fs``; a tail shorter than ``burst`` runs as single steps.
      source_ready: whether the source's next block is already waiting
        (a ring's depth above 0).  When it is not, each unit is published
        as soon as its step's outputs are on the host instead of after the
        next block is pulled.  None: always waiting (an iterable whose
        next block is at hand).  Under ``realtime_fs`` the next block is
        waiting only once its deadline has passed, so a paced block is
        delivered before the pacing sleep.

    Returns PipelineMetrics, or ``(metrics, final_state)`` with return_state.
    """
    burst = max(1, int(burst))
    if burst > 1 and realtime_fs:
        raise ValueError(
            "burst > 1 is an offline-throughput mode; realtime pacing "
            "requires per-block dispatch (burst=1)"
        )
    metrics = PipelineMetrics()
    metrics.start()
    if state is None:
        state = rx.init_state()
    t_block = rx.block
    it = iter(blocks)
    if max_blocks is not None:
        it = itertools.islice(it, max_blocks)
    tr = trace.current()
    timeline = tr is not None and tr.timeline(rx.device)
    if timeline:
        tr.calibrate()
        tr.stream = torch.cuda.current_stream()  # the stream the blocks' work goes to
    depth = tr.depth() if tr is not None else 0

    def keep(key: str) -> bool:
        # nothing is copied to the host when no callback reads it
        return on_outputs is not None and (fetch_filter is None or fetch_filter(key))

    def publish(unit: tuple | None) -> int:
        """Wait for one unit's copies and fire the per-block callbacks."""
        if unit is None:
            return 0
        fetched, k, b, timing = unit
        if tr is not None:
            s = tr.begin("runtime.fetch_wait", time.monotonic_ns(), b)
        host = fetched.numpy(keep)
        if tr is not None:
            t = time.monotonic_ns()
            tr.end(s, t)
            s = tr.begin("runtime.deliver", t, b)
        sent = 0
        if on_outputs is not None:
            frames = [host] if k is None else rx.unstack_outputs(host, k)
            sent = sum(on_outputs(rx.split_audio(f)) for f in frames)
        if tr is not None:
            tr.end(s, time.monotonic_ns())
            if timing is not None:  # its D2H event has completed: read the set, after delivery
                tr.device_entry(b, timing)
        return sent

    def ready() -> bool:
        """Whether the source's next block is already waiting."""
        if realtime_fs and time.monotonic() < next_deadline:
            return False
        return source_ready is None or source_ready()

    if tr is not None:
        tr.add("runtime.published_early", 0)  # reads 0 where every unit is held
    pending = None
    next_deadline = time.monotonic()
    try:
        while True:
            if tr is not None:
                t = time.monotonic_ns()
                s_blk = tr.begin("runtime.block", t, tr.next_block)
                s = tr.begin("runtime.source_wait", t)
            stack = list(itertools.islice(it, burst))
            t0 = time.monotonic_ns()
            if not stack:
                if tr is not None:
                    tr.drop(s)
                    tr.drop(s_blk)
                break
            if tr is not None:
                tr.end(s, t0)
            if len(stack) == burst and burst > 1:
                units = [(torch.stack([torch.as_tensor(b) for b in stack]), burst)]
            else:
                units = [(b, None) for b in stack]
            for j, (blk, k) in enumerate(units):
                # under burst the unit's time is split evenly over its blocks
                # and the messages published in its iteration (the previous
                # unit's; its own, published early) go to its first block
                n = k or 1
                b = timing = None
                if j:
                    t0 = time.monotonic_ns()
                if tr is not None:
                    if j:
                        s_blk = tr.begin("runtime.block", t0, tr.next_block)
                    b, tr.next_block = tr.next_block, tr.next_block + n
                    timing = tr.timing = tr.events() if timeline else None
                    s = tr.begin("runtime.upload", t0)
                x = _upload(rx, blk)
                if tr is not None:
                    t = time.monotonic_ns()
                    tr.end(s, t)
                    if timing is not None:
                        # event 2 marks the step's start; a graph step marks
                        # it again, directly before its first stream work
                        tr.mark(1)
                        tr.mark(2)
                    s = tr.begin("step.enqueue", t)
                state, outs = _step(rx, state, x, raw_u8, k is not None)
                if tr is not None:
                    tr.end(s, time.monotonic_ns())
                    if timing is not None:
                        tr.mark(3)
                # publish the previous unit, if held, while this one
                # computes; then queue this one's copies, so the filter's
                # first answer has seen every earlier callback and is the
                # one it gives at publish unless the filter changes in
                # between
                sent = publish(pending)
                pending = (_Fetched(outs, keep, rx.device, tr if timing else None), k, b, timing)
                if realtime_fs:
                    next_deadline += t_block / realtime_fs
                if j == len(units) - 1 and not ready():
                    # nothing waits at the source: holding this unit for
                    # the next block would only delay its audio
                    sent += publish(pending)
                    pending = None
                    metrics.published_early += 1
                    if tr is not None:
                        tr.add("runtime.published_early")
                t_compute = (time.monotonic_ns() - t0) / 1e9
                slack = 0.0
                if realtime_fs:
                    slack = next_deadline - time.monotonic()
                    if slack > 0:
                        time.sleep(slack)
                    else:
                        # behind realtime: resync (a dongle's lost time is lost)
                        next_deadline = time.monotonic()
                for i in range(n):
                    metrics.record_block(
                        t_block, t_compute / n, sent if i == 0 else 0,
                        pacing_slack=slack if realtime_fs else None,
                    )
                if tr is not None:
                    tr.end(s_blk, time.monotonic_ns())
        metrics.messages_sent += publish(pending)
    finally:
        if tr is not None:
            tr.unwind(depth)
            tr.timing = None
    metrics.finish()
    if return_state:
        return metrics, state
    return metrics
