"""The traced run's device profile and what the per-layer readers read.

``DeviceTrace`` runs ``torch.profiler`` over CUDA activity only (no CPU
operator events), over a slice of the timed window itself: ``trace_blocks``
consecutive blocks, opened and closed by ``Slice`` just before a block's
upload, with the card synchronised at both ends.  ``reduce`` turns it
into per-row device time, the seconds in which some device operation ran
(the union of their intervals) and the longest idle gaps, each named by
the innermost harness span (``program.Spans``) running on the host at the
gap's middle: the device clock is tied to the host's at the first
upload of the slice, whose copy is the slice's first device operation.
Host times per block are read outside the slice, where no profiler runs;
those inside it give the profiler's own cost on the host.
"""

from __future__ import annotations

import dataclasses
import time

import torch

__all__ = ["DeviceTrace", "Slice", "TraceData"]


@dataclasses.dataclass
class TraceData:
    """What a per-layer reader reads (``benchmark/metrics/<name>.py``)."""

    kind: str  # "file" or "live"
    cfg: dict
    traffic: dict
    block: int
    steps: int = 0  # steps inside the profile
    window_s: float = 0.0  # the profile's length
    busy_s: float = 0.0  # seconds in which a device operation ran
    rows: dict = dataclasses.field(default_factory=dict)  # name -> [total us, count]
    gaps: list = dataclasses.field(default_factory=list)  # [(label, seconds)] longest first
    spans: dict = dataclasses.field(default_factory=dict)  # span -> [seconds], unprofiled
    block_seconds: list = dataclasses.field(default_factory=list)  # PipelineMetrics, unprofiled
    block_seconds_profiled: list = dataclasses.field(default_factory=list)  # inside the slice

    def row_us(self, part: str) -> tuple[float, int]:
        """(total µs, count) of the device rows whose name contains ``part``."""
        hit = [v for k, v in self.rows.items() if part in k]
        return sum(v[0] for v in hit), sum(v[1] for v in hit)

    def breakdown(self) -> dict:
        ops = sorted(self.rows.items(), key=lambda kv: -kv[1][0])[:10]
        return {"device_ops": [[k[:120], v[0] / 1e6] for k, v in ops],
                "idle_gaps": [[k, s] for k, s in self.gaps[:10]]}


class DeviceTrace:
    def __init__(self):
        self.prof = None
        self.t0 = self.t1 = None

    @property
    def active(self) -> bool:
        return self.prof is not None and self.t1 is None

    @staticmethod
    def _profile():
        from torch.profiler import ProfilerActivity, profile

        return profile(activities=[ProfilerActivity.CUDA])

    @classmethod
    def warm(cls) -> None:
        """Profile one small CUDA operation: the first profile of a process
        initialises the tracer, which takes seconds; set-up pays that."""
        prof = cls._profile()
        prof.start()
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        prof.stop()
        prof.events()

    def start(self) -> None:
        torch.cuda.synchronize()
        self.prof = self._profile()
        self.prof.start()
        self.t0 = time.monotonic()

    def stop(self) -> None:
        if self.active:
            torch.cuda.synchronize()
            self.t1 = time.monotonic()
            self.prof.stop()

    def reduce(self, t: TraceData, spans: dict[str, list[tuple[float, float]]]) -> None:
        """Fill ``t``'s device fields from the profile; ``spans`` are the
        host spans by name, (monotonic start, seconds)."""
        if self.prof is None:
            return
        self.stop()
        dev = []
        for e in self.prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                r = e.time_range
                dev.append((r.start, r.end))
                row = t.rows.setdefault(e.name, [0.0, 0])
                row[0] += r.end - r.start
                row[1] += 1
        t.window_s = self.t1 - self.t0
        dev.sort()
        busy, gaps, end = 0.0, [], None
        for s, e in dev:
            if end is None or s > end:
                if end is not None:
                    gaps.append((end, s))
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        t.busy_s = busy / 1e6
        if not dev:
            return
        # the host's clock at the device's first operation: the end of the
        # slice's first upload (its copy), else the profile's start
        ups = [s + d for s, d in spans.get("runtime.upload", []) if s >= self.t0]
        anchor = min(ups, default=self.t0)
        host = [(s, s + d, name) for name, v in spans.items() for s, d in v
                if self.t0 - 1.0 <= s <= self.t1]
        gaps.sort(key=lambda g: g[0] - g[1])
        for s, e in gaps[:10]:
            mid = anchor + ((s + e) / 2 - dev[0][0]) / 1e6
            cover = [h for h in host if h[0] <= mid <= h[1]]
            label = min(cover, key=lambda h: h[1] - h[0])[2] if cover else "host: no harness span"
            t.gaps.append((label, (e - s) / 1e6))


class Slice:
    """Opens a ``DeviceTrace`` (``profile``: on the card) just before the
    upload of the first block, by the upload's call index, at or after
    ``first`` whose upload starts at or after ``t_from``, and closes it
    ``n`` blocks later or at ``close()``.  ``period`` is (opened, closed)
    on the host's clock: the stretch whose host times carry the profiler."""

    def __init__(self, n: int, first: int = 0, t_from: float = 0.0, profile: bool = True):
        self.n, self.first, self.t_from = int(n), int(first), t_from
        self.trace = DeviceTrace() if profile else None
        self.opened_at: int | None = None
        self.steps = 0  # blocks uploaded inside the slice
        self.period = (float("inf"), float("inf"))

    def before_upload(self, i: int) -> None:
        if self.opened_at is None:
            if i >= self.first and time.monotonic() >= self.t_from:
                t = time.monotonic()
                if self.trace is not None:
                    self.trace.start()
                self.opened_at = i
                self.period = (t, float("inf"))
                self.steps = 1
        elif self.period[1] == float("inf"):
            if i == self.opened_at + self.n:
                self.close()
            else:
                self.steps += 1

    def close(self) -> None:
        if self.opened_at is not None and self.period[1] == float("inf"):
            if self.trace is not None:
                self.trace.stop()
            self.period = (self.period[0], time.monotonic())

    def outside(self, at: float) -> bool:
        return not self.period[0] <= at <= self.period[1]
