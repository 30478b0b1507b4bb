"""In-program tracing: spans, counters and a device timeline from CUDA events.

One record per process, off by default.  :func:`enable` turns it on,
:func:`current` hands it to the instrumented code (``None`` while it is
off, so an instrumented boundary costs one branch), :func:`snapshot`
returns what it holds as plain lists and :func:`disable` turns it off.
Its memory is allocated by :func:`enable` and bounded: spans, device
entries and counter samples are rings that keep the newest entries, so a
live session of hours holds fixed memory; the snapshot counts what they
lost (``spans_lost``, ``device_lost``).  Nothing is written out until the caller asks (``run`` / ``process-file
--trace-out FILE``: :func:`write_chrome`).

Every time is ``time.monotonic_ns()``: CLOCK_MONOTONIC, the clock of C++
``steady_clock`` on Linux, which stamps the ingest ring's slots.

A span is a name, a start, an end, its parent (the sequence number of the
span open when it began, -1 for none) and a block index, the request id
that all spans of one block share (-1: no block).  The spans:

========================  =============================================  ==================
name                      where                                          parent
========================  =============================================  ==================
``runtime.block``         one iteration of ``run_pipeline``'s loop        none
``runtime.source_wait``   pulling the next block from the source          ``runtime.block``
``ring.queue``            a block's push into the ingest ring to its pop  none
``runtime.upload``        pinning and the H2D enqueue                     ``runtime.block``
``step.enqueue``          the step: input copy, graph replay, outputs     ``runtime.block``
``runtime.fetch_wait``    the wait for a block's D2H copies               ``runtime.block``
``runtime.deliver``       ``split_audio`` and the caller's callback       ``runtime.block``
``egress.publish``        ``EgressHub.publish_outputs``                   ``runtime.deliver``
``step.capture``          ``StepGraphs`` capturing one entry's graph      none
========================  =============================================  ==================

``runtime.fetch_wait`` and ``runtime.deliver`` carry the index of the block
they fetch and publish: the previous one where that block was held for the
next, the block's own where it was published early; a block still held
when the source ends is published after the loop, with no parent.
Counters: ``step.captures`` and ``step.capture_ns`` (the graphs captured
and the ns their captures took), ``ring.high_water`` (the most ring slots
ever full) and ``runtime.published_early`` (the units ``run_pipeline``
published before pulling the next block, 0 where it held every one).

The device timeline (on the card): six timing events bracket each block's
three pieces of stream work (``EVENTS``): before and after the H2D copy,
before the step's first stream operation (``StepGraphs.step`` records it
directly before the input copy, after the host's own part of the step)
and after the step, before and after the D2H copies.  ``run_pipeline``
reads them when the block is fetched; the sets return to a small pool.
An event's host time is one calibration event's host time plus the
elapsed time to the block's first event, then the elapsed times between
adjacent events.  The gaps between the pieces are left unbridged, so the
stream's idle time, the host's enqueue of the step included, shows as
idle.

The readings below (:func:`durations_ns`, :func:`holds_ns`,
:func:`device_intervals`, :func:`idle_share`) take an optional set of
block indices, the blocks to read; the CLI's summary reads every block.
"""

from __future__ import annotations

import array
import bisect
import json
import time

import numpy as np

__all__ = ["Tracer", "enable", "disable", "current", "snapshot", "self_ns", "durations_ns",
           "holds_ns", "device_intervals", "idle_share", "idle_gaps", "summarize", "chrome",
           "write_chrome"]

SPANS = 1 << 18  # ~9 MB: the newest 40,000 blocks of a closed loop
DEVICE = 1 << 15
# a block's timing events: before/after the H2D copy, the step's start/end,
# before/after the D2H copies; each piece's (first, last) event
EVENTS = 6
PIECES = {"h2d": (0, 1), "step": (2, 3), "d2h": (4, 5)}
SAMPLES = 1 << 14
REANCHOR_NS = 30e9  # the device timeline's calibration moves to a block's event this often
HOST_ONLY = ("ring.queue",)  # spans that are not work on the pipeline's thread


def _ring(code: str, n: int) -> array.array:
    return array.array(code, bytes(array.array(code).itemsize * n))


class Tracer:
    """The record: preallocated rings of spans, device entries and counter
    samples.  Use through :func:`enable` / :func:`current`."""

    def __init__(self, spans: int = SPANS, device: int = DEVICE, samples: int = SAMPLES):
        self.cap, self.dcap, self.scap = int(spans), int(device), int(samples)
        self.names: list[str] = []
        self._ids: dict[str, int] = {}
        self._name, self._block = _ring("h", self.cap), _ring("q", self.cap)
        self._start, self._end, self._parent = (_ring("q", self.cap) for _ in range(3))
        self.n = 0  # spans begun
        self._open: list[int] = []  # sequence numbers of the open spans, innermost last
        self.next_block = 0  # the next block index run_pipeline hands out
        self.counters: dict[str, int] = {}
        self._sname, self._st, self._sv = _ring("h", self.scap), _ring("q", self.scap), _ring(
            "q", self.scap)
        self.nsamples = 0
        self._dblock, self._dev = _ring("q", self.dcap), _ring("d", EVENTS * self.dcap)
        self.ndev = 0
        self.timing: list | None = None  # the unit in flight's events
        self.stream = None  # the stream they are recorded on (run_pipeline sets it)
        self._pool: list[list] = []
        self.events_made = 0  # timing events ever made
        self._cal = None  # (calibration event, its host time in ns)

    def _id(self, name: str) -> int:
        i = self._ids.get(name)
        if i is None:
            i = self._ids[name] = len(self.names)
            self.names.append(name)
        return i

    # ------------------------------------------------------------ spans
    def begin(self, name: str, t: int, block: int | None = None) -> int:
        """Open a span at ``t``, a child of the open span; ``block``
        defaults to the parent's.  Returns its sequence number."""
        seq, i = self.n, self.n % self.cap
        p = self._open[-1] if self._open else -1
        self._name[i] = self._id(name)
        self._start[i], self._end[i], self._parent[i] = t, -1, p
        self._block[i] = block if block is not None else (
            self._block[p % self.cap] if p >= 0 else -1)
        self._open.append(seq)
        self.n = seq + 1
        return seq

    def end(self, seq: int, t: int) -> None:
        """Close span ``seq`` at ``t``."""
        if self.n - seq <= self.cap:
            self._end[seq % self.cap] = t
        self._unopen(seq)

    def drop(self, seq: int) -> None:
        """Forget an open span (it stays unclosed, so it is never exported)."""
        self._unopen(seq)

    def _unopen(self, seq: int) -> None:
        if self._open and self._open[-1] == seq:
            self._open.pop()
        elif seq in self._open:
            self._open.remove(seq)

    def span(self, name: str, t0: int, t1: int, block: int | None = None,
             child: bool = True) -> None:
        """A closed span ``[t0, t1]``: a child of the open span (``child``)
        or parentless; ``block`` defaults to the open span's."""
        p = self._open[-1] if self._open else -1
        if block is None:
            block = self._block[p % self.cap] if p >= 0 else -1
        seq, i = self.n, self.n % self.cap
        self.n = seq + 1
        self._name[i] = self._id(name)
        self._start[i], self._end[i] = t0, t1
        self._parent[i] = p if child else -1
        self._block[i] = block

    def depth(self) -> int:
        return len(self._open)

    def unwind(self, depth: int) -> None:
        """Forget spans left open above ``depth`` (an exception's way out)."""
        del self._open[depth:]

    # ---------------------------------------------------------- counters
    def count(self, name: str, value: int) -> None:
        """Set counter ``name`` to ``value``, sampled now."""
        self.counters[name] = value
        i = self.nsamples % self.scap
        self._sname[i], self._st[i], self._sv[i] = self._id(name), time.monotonic_ns(), value
        self.nsamples += 1

    def add(self, name: str, k: int = 1) -> None:
        self.count(name, self.counters.get(name, 0) + k)

    # --------------------------------------------------- device timeline
    def timeline(self, device) -> bool:
        """Whether blocks on ``device`` get timing events: on the card."""
        return device.type == "cuda"

    def calibrate(self) -> None:
        """Tie the device's event clock to the host's once: after a
        synchronize, one event recorded and waited for between two host
        readings, whose midpoint it is given."""
        if self._cal is not None:
            return
        import torch

        torch.cuda.synchronize()
        ev = torch.cuda.Event(enable_timing=True)
        self.events_made += 1
        t0 = time.monotonic_ns()
        ev.record()
        ev.synchronize()
        self._cal = (ev, (t0 + time.monotonic_ns()) // 2)

    def mark(self, k: int) -> None:
        """Record the unit in flight's timing event ``k`` on ``stream`` (a
        stream given: ``Event.record()`` would look it up, ~10 µs)."""
        self.timing[k].record(self.stream)

    def events(self) -> list:
        """A set of ``EVENTS`` timing events, from the pool when one is free."""
        if self._pool:
            return self._pool.pop()
        import torch

        self.events_made += EVENTS
        return [torch.cuda.Event(enable_timing=True) for _ in range(EVENTS)]

    def device_entry(self, block: int, evs: list) -> None:
        """Read a fetched block's events (its last has completed, so all
        have) into the timeline, and return them to the pool."""
        cal, t_cal = self._cal
        t = t_cal + cal.elapsed_time(evs[0]) * 1e6
        i = self.ndev % self.dcap
        self._dblock[i] = block
        j = EVENTS * i
        self._dev[j] = t
        for k in range(1, EVENTS):
            self._dev[j + k] = self._dev[j + k - 1] + evs[k - 1].elapsed_time(evs[k]) * 1e6
        if t - t_cal > REANCHOR_NS:
            # elapsed_time is a float32 of ms: keep the calibration near, so
            # positions stay within a µs in a session of hours
            import torch

            self._cal, evs[0] = (evs[0], t), torch.cuda.Event(enable_timing=True)
            self.events_made += 1
        self.ndev += 1
        self._pool.append(evs)

    # ---------------------------------------------------------- snapshot
    def snapshot(self) -> dict:
        """What the record holds, as plain lists (times in ns of
        CLOCK_MONOTONIC).  ``spans``: closed spans in the order they began,
        the oldest that a full ring overwrote left out (``spans_lost``);
        ``device``: per block, its ``EVENTS`` events' host times
        (``device_lost``: entries overwritten)."""

        def newest(n: int, cap: int) -> np.ndarray:
            return np.arange(max(0, n - cap), n) % cap

        i = newest(self.n, self.cap)
        end = np.frombuffer(self._end, np.int64)[i]
        ok = end >= 0
        names = np.asarray(self.names + [""], dtype=object)
        spans = {"seq": np.arange(max(0, self.n - self.cap), self.n)[ok],
                 "name": names[np.frombuffer(self._name, np.int16)[i][ok]],
                 "start": np.frombuffer(self._start, np.int64)[i][ok], "end": end[ok],
                 "parent": np.frombuffer(self._parent, np.int64)[i][ok],
                 "block": np.frombuffer(self._block, np.int64)[i][ok]}
        d = newest(self.ndev, self.dcap)
        dev = np.frombuffer(self._dev, np.float64).reshape(-1, EVENTS)
        s = newest(self.nsamples, self.scap)
        return {
            "clock": "CLOCK_MONOTONIC ns",
            "spans": {k: v.tolist() for k, v in spans.items()},
            "spans_lost": max(0, self.n - self.cap),
            "device": {"block": np.frombuffer(self._dblock, np.int64)[d].tolist(),
                       "events": dev[d].tolist()},
            "device_lost": max(0, self.ndev - self.dcap),
            "counters": dict(self.counters),
            "samples": {"name": names[np.frombuffer(self._sname, np.int16)[s]].tolist(),
                        "t": np.frombuffer(self._st, np.int64)[s].tolist(),
                        "value": np.frombuffer(self._sv, np.int64)[s].tolist()},
            "events_made": self.events_made,
        }


_tracer: Tracer | None = None


def enable(**sizes) -> Tracer:
    """Turn tracing on with a fresh record (``spans``, ``device``,
    ``samples``: ring sizes) and return it."""
    global _tracer
    _tracer = Tracer(**sizes)
    return _tracer


def disable() -> None:
    global _tracer
    _tracer = None


def current() -> Tracer | None:
    """The record while tracing is on, else None."""
    return _tracer


def snapshot() -> dict | None:
    """The record's :meth:`Tracer.snapshot`, or None while tracing is off."""
    return None if _tracer is None else _tracer.snapshot()


# ------------------------------------------------------------------ readings
def _arrays(rec: dict, blocks=None) -> dict:
    """The spans as arrays; only those of ``blocks`` where given."""
    s = rec["spans"]
    a = {"name": np.asarray(s["name"], dtype=object), "start": np.asarray(s["start"], np.int64),
         "end": np.asarray(s["end"], np.int64), "seq": np.asarray(s["seq"], np.int64),
         "parent": np.asarray(s["parent"], np.int64), "block": np.asarray(s["block"], np.int64)}
    if blocks is not None:
        m = np.isin(a["block"], np.fromiter(blocks, np.int64))
        a = {k: v[m] for k, v in a.items()}
    return a


def self_ns(rec: dict) -> list[int]:
    """Each span's self time: its duration less the part of it that its
    children cover."""
    s = rec["spans"]
    pos = {q: j for j, q in enumerate(s["seq"])}
    kids: dict[int, list[tuple[int, int]]] = {}
    for j, p in enumerate(s["parent"]):
        if p in pos:
            kids.setdefault(pos[p], []).append((s["start"][j], s["end"][j]))
    out = []
    for j, (a, b) in enumerate(zip(s["start"], s["end"])):
        covered, reach = 0, a
        for c0, c1 in sorted(kids.get(j, ())):
            c0, c1 = max(c0, reach), min(c1, b)
            if c1 > c0:
                covered += c1 - c0
                reach = c1
        out.append(b - a - covered)
    return out


def durations_ns(rec: dict, name: str, blocks=None) -> np.ndarray:
    """The ns of every span ``name`` (of ``blocks``)."""
    a = _arrays(rec, blocks)
    m = a["name"] == name
    return a["end"][m] - a["start"][m]


def holds_ns(rec: dict, blocks=None) -> dict[int, int]:
    """Per block (of ``blocks``), the hold: from the end of its
    ``step.enqueue`` to the start of its ``runtime.deliver``."""
    a = _arrays(rec, blocks)

    def by_block(name: str, field: str) -> dict[int, int]:
        m = a["name"] == name
        return dict(zip(a["block"][m].tolist(), a[field][m].tolist()))

    done, out = by_block("step.enqueue", "end"), by_block("runtime.deliver", "start")
    return {b: out[b] - t for b, t in done.items() if b in out}


def device_intervals(rec: dict, blocks=None) -> dict[str, np.ndarray]:
    """Per block of the timeline (of ``blocks``; ``block``): the H2D, step
    and D2H intervals in ns (``h2d``, ``step``, ``d2h``), their sum
    (``busy``) and the ``EVENTS`` event times (``events``), in the
    timeline's order; ``next``: whether the entry after it in the timeline
    is kept too."""
    blk = np.asarray(rec["device"]["block"], np.int64)
    ev = np.asarray(rec["device"]["events"], np.float64).reshape(-1, EVENTS)
    keep = np.ones(len(blk), bool) if blocks is None else np.isin(
        blk, np.fromiter(blocks, np.int64))
    out = {"block": blk[keep], "events": ev[keep], "next": np.append(keep[1:], False)[keep]}
    for piece, (i, j) in PIECES.items():
        out[piece] = out["events"][:, j] - out["events"][:, i]
    out["busy"] = out["h2d"] + out["step"] + out["d2h"]
    return out


def idle_share(rec: dict, blocks=None) -> float | None:
    """The share of the time that the stream is idle: one less the H2D,
    step and D2H intervals summed over the periods they lie in, each from
    a block's first event to the next block's, over the blocks (of
    ``blocks``) whose next block in the timeline is read too (so no period
    holds an unread block).  None where no period is read."""
    d = device_intervals(rec, blocks)
    ev, nxt = d["events"], d["next"]
    if not nxt.any():
        return None
    later = np.flatnonzero(nxt) + 1  # the next entry is the following row
    busy = float(d["busy"][nxt].sum())
    span = float((ev[later, 0] - ev[nxt, 0]).sum())
    return 1.0 - busy / span if span > 0 else None


def idle_gaps(rec: dict) -> list[tuple[float, float, str]]:
    """Every stream-idle interval of the timeline, ``(start, end, label)``
    in host ns, ``label`` the innermost program span running on the host
    at its midpoint (``"host: no program span"`` where none is).  Each of
    a block's three pieces is busy on its own, so the host's enqueue of a
    step, between the H2D copy and the step's first operation, shows."""
    d = device_intervals(rec)
    busy = sorted((float(e[a]), float(e[b])) for e in d["events"] for a, b in PIECES.values())
    a = _arrays(rec)
    host = np.isin(a["name"], HOST_ONLY, invert=True)
    order = np.argsort(a["start"][host], kind="stable")
    starts = a["start"][host][order].tolist()
    ends = a["end"][host][order].tolist()
    names = a["name"][host][order].tolist()
    out, reach = [], None
    for s, e in busy:
        if reach is not None and s > reach:
            mid = (reach + s) / 2
            label = "host: no program span"
            j = bisect.bisect_right(starts, mid) - 1
            for k in range(j, max(j - 32, -1), -1):  # innermost: latest start covering mid
                if ends[k] >= mid:
                    label = names[k]
                    break
            out.append((reach, s, label))
        reach = e if reach is None else max(reach, e)
    return out


def _p50(v) -> float | None:
    return float(np.median(v)) if len(v) else None


def summarize(rec: dict) -> dict:
    """Per-span medians (ms, and of self time), the hold's median, the
    timeline's median intervals (µs) and idle share, idle seconds by the
    span that held the host, and the counters."""
    a = _arrays(rec)
    own = np.asarray(self_ns(rec), np.float64)
    dur = (a["end"] - a["start"]).astype(np.float64)
    spans = {}
    for name in dict.fromkeys(a["name"].tolist()):
        m = a["name"] == name
        spans[name] = {"n": int(m.sum()), "p50_ms": round(_p50(dur[m]) / 1e6, 4),
                       "self_p50_ms": round(_p50(own[m]) / 1e6, 4)}
    out = {"spans": spans, "counters": dict(rec["counters"]), "spans_lost": rec["spans_lost"]}
    hold = list(holds_ns(rec).values())
    if hold:
        out["hold_p50_ms"] = round(_p50(hold) / 1e6, 4)
    d = device_intervals(rec)
    if len(d["block"]):
        out["device_us_p50"] = {k: round(_p50(d[k]) / 1e3, 3) for k in PIECES}
        share = idle_share(rec)
        if share is not None:
            out["device_idle_share"] = round(share, 5)
        idle: dict[str, float] = {}
        for s, e, label in idle_gaps(rec):
            idle[label] = idle.get(label, 0.0) + (e - s) / 1e9
        out["idle_s_by_span"] = {k: round(v, 6) for k, v in
                                 sorted(idle.items(), key=lambda kv: -kv[1])}
    return out


def chrome(rec: dict) -> dict:
    """The record as Chrome trace-event JSON (Perfetto opens it): spans as
    complete events in µs of CLOCK_MONOTONIC with their block in ``args``,
    the ring's queue and the device intervals on tracks of their own, and
    the counters' samples."""
    tracks = {"host": 1, "ring": 2, "device (CUDA events)": 3}
    ev: list[dict] = [{"ph": "M", "name": "process_name", "pid": 1,
                       "args": {"name": "sdrreceiver_tpu_torch"}}]
    ev += [{"ph": "M", "name": "thread_name", "pid": 1, "tid": tid, "args": {"name": name}}
           for name, tid in tracks.items()]
    s = rec["spans"]
    names = dict(zip(s["seq"], s["name"]))
    for q, n, t0, t1, p, b in zip(s["seq"], s["name"], s["start"], s["end"], s["parent"],
                                  s["block"]):
        ev.append({"ph": "X", "name": n, "cat": n.split(".")[0], "ts": t0 / 1e3,
                   "dur": (t1 - t0) / 1e3, "pid": 1, "tid": 2 if n in HOST_ONLY else 1,
                   "args": {"block": b, "seq": q, "parent": names.get(p)}})
    d = device_intervals(rec)
    for b, e in zip(d["block"].tolist(), d["events"].tolist()):
        for n, (i, j) in PIECES.items():
            ev.append({"ph": "X", "name": n, "cat": "device", "ts": e[i] / 1e3,
                       "dur": (e[j] - e[i]) / 1e3, "pid": 1, "tid": 3, "args": {"block": b}})
    c = rec["samples"]
    ev += [{"ph": "C", "name": n, "ts": t / 1e3, "pid": 1, "args": {n: v}}
           for n, t, v in zip(c["name"], c["t"], c["value"])]
    return {"traceEvents": ev, "displayTimeUnit": "ms",
            "otherData": {"clock": "CLOCK_MONOTONIC", "spans_lost": rec["spans_lost"],
                          "device_lost": rec["device_lost"]}}


def write_chrome(path, rec: dict) -> None:
    with open(path, "w") as f:
        json.dump(chrome(rec), f)
