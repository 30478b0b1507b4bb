"""The port's in-program tracer (``obs/trace.py``) and its hooks in
``run_pipeline``, the ingest ring, the egress hub, ``StepGraphs`` and the
CLI's ``--trace-out``.  Runs on the CPU: the card's timing events are
stood in for by events that read the host's clock when recorded, which the
device timeline's logic cannot tell apart.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from sdrreceiver_tpu_torch.cli.main import main
from sdrreceiver_tpu_torch.core import runtime
from sdrreceiver_tpu_torch.flagship import altrate_config
from sdrreceiver_tpu_torch.graph import cudagraph
from sdrreceiver_tpu_torch.graph.compiler import CompiledReceiver
from sdrreceiver_tpu_torch.graph.config import parse_ini_text
from sdrreceiver_tpu_torch.graph.plan import build_plan
from sdrreceiver_tpu_torch.io import iqfile, native
from sdrreceiver_tpu_torch.io.iqfile import synthesize_channels, to_u8
from sdrreceiver_tpu_torch.obs import trace
from test_torch_modules import _to_ini

# six xdist workers share the machine's cores: a few torch threads each
torch.set_num_threads(2)

BLOCK = 15360
PER_BLOCK = ("runtime.block", "runtime.source_wait", "runtime.upload", "step.enqueue",
             "runtime.fetch_wait", "runtime.deliver")


@pytest.fixture(scope="module")
def rx():
    return CompiledReceiver(build_plan(parse_ini_text(_to_ini(altrate_config()))), BLOCK,
                            device="cpu")


@pytest.fixture(scope="module")
def raw(rx):
    plan = rx.plan
    subs = [s for g in plan.groups for b in g.buckets for s in b.subs]
    iq = synthesize_channels(6 * BLOCK, plan.fs, plan.center_frequency,
                             [(s.frequency, 700 + 37 * i, 1.0) for i, s in enumerate(subs)],
                             noise=0.5, dc_offset=1 - 2j, seed=5)
    return to_u8(iq).reshape(6, -1)


@pytest.fixture(autouse=True)
def off():
    trace.disable()
    yield
    trace.disable()


class FakeEvent:
    """A timing event that reads the host's clock when recorded."""

    made = 0

    def __init__(self, enable_timing=False):
        type(self).made += 1
        self.t = None

    def record(self, stream=None):
        self.t = time.monotonic_ns()

    def synchronize(self):
        assert self.t is not None

    def elapsed_time(self, other):
        return (other.t - self.t) / 1e6


@pytest.fixture
def events(monkeypatch):
    """Timing events on the CPU: a CPU receiver's blocks get the timeline."""
    FakeEvent.made = 0
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: None)
    monkeypatch.setattr(trace.Tracer, "timeline", lambda self, device: True)
    return FakeEvent


def _run(rx, blocks, cb=None, **kw):
    got = []

    def sink(outs):
        got.append(outs)
        return cb(outs) if cb else 0

    runtime.run_pipeline(rx, iter(blocks), sink, raw_u8=True, **kw)
    return got


def _spans(rec):
    s = rec["spans"]
    return [dict(zip(s, row)) for row in zip(*s.values())]


# ------------------------------------------------------------------ off
def test_off_records_nothing_and_outputs_equal_on(rx, raw, monkeypatch):
    made = []
    monkeypatch.setattr(torch.cuda, "Event", lambda *a, **k: made.append(1))
    off = _run(rx, raw[:4])
    assert trace.current() is None and trace.snapshot() is None and made == []
    tr = trace.enable()
    on = _run(rx, raw[:4])
    # a CPU receiver gets no timeline: no event, an empty pool
    assert made == [] and tr.events_made == 0 and tr._pool == [] and tr.ndev == 0
    assert len(on) == len(off) == 4
    for a, b in zip(on, off):
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


def test_on_with_timeline_outputs_equal_off(rx, raw, events):
    off = _run(rx, raw[:3])
    assert events.made == 0
    tr = trace.enable()
    on = _run(rx, raw[:3])
    # one calibration event, six a block from a pool of at most two sets
    assert events.made == tr.events_made <= 1 + 2 * trace.EVENTS and tr.ndev == 3
    for a, b in zip(on, off):
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


# ------------------------------------------------------------------ spans
@pytest.mark.parametrize("burst", [1, 2])
def test_every_block_has_its_spans(rx, raw, burst):
    trace.enable()
    _run(rx, raw[:5], burst=burst)
    rec = trace.snapshot()
    spans = _spans(rec)
    by_seq = {s["seq"]: s for s in spans}
    units = sorted({s["block"] for s in spans})
    step = burst if burst > 1 else 1
    # burst 2 over 5 blocks: two bursts (blocks 0, 2) and a single tail (4)
    assert units == ([0, 1, 2, 3, 4] if burst == 1 else [0, 2, 4])
    for b in units:
        mine = [s for s in spans if s["block"] == b]
        assert sorted(s["name"] for s in mine) == sorted(PER_BLOCK), (b, mine)
        top = next(s for s in mine if s["name"] == "runtime.block")
        assert top["parent"] == -1
        for s in mine:
            if s["name"] in ("runtime.source_wait", "runtime.upload", "step.enqueue"):
                assert s["parent"] == top["seq"]
            elif s["name"] != "runtime.block":
                # fetched and delivered inside the next unit's iteration; the
                # last unit's after the loop
                p = by_seq.get(s["parent"])
                if b == units[-1]:
                    assert s["parent"] == -1
                else:
                    nxt = units[units.index(b) + 1]
                    assert p["name"] == "runtime.block" and p["block"] == nxt, (b, s, p)
                    assert p["block"] - b in (1, step)
            assert s["start"] <= s["end"]
    # self time: the span less the union of its children
    own = trace.self_ns(rec)
    for s, o in zip(spans, own):
        kids = sorted((c["start"], c["end"]) for c in spans if c["parent"] == s["seq"])
        covered = sum(e - a for a, e in kids)  # siblings here never overlap
        assert o == s["end"] - s["start"] - covered
        assert o >= 0
    assert trace.summarize(rec)["spans"]["runtime.block"]["n"] == len(units)


def test_siblings_are_ordered_and_disjoint(rx, raw):
    trace.enable()
    _run(rx, raw[:4])
    spans = _spans(trace.snapshot())
    groups = {}
    for s in spans:
        key = s["parent"] if s["parent"] >= 0 else ("top", s["name"])
        groups.setdefault(key, []).append(s)
    for sib in groups.values():
        for a, b in zip(sib, sib[1:]):  # in the order they began
            assert a["start"] <= b["start"] and a["end"] <= b["start"], (a, b)


def test_ring_queue_through_ingest_ring(rx, raw):
    if not native.available():
        pytest.skip("the native ring does not build here")
    ring = native.IngestRing(block_bytes=raw.shape[1], n_slots=4)
    for b in raw[:3]:
        assert ring.push(b) == 0
    pushed = time.monotonic_ns()
    time.sleep(0.03)
    ring.close()
    trace.enable()

    def blocks():
        while (b := ring.pop_raw(timeout_ms=1000)) is not None:
            yield b

    _run(rx, blocks())
    rec = trace.snapshot()
    spans = _spans(rec)
    q = [s for s in spans if s["name"] == "ring.queue"]
    assert [s["block"] for s in q] == [0, 1, 2] and all(s["parent"] == -1 for s in q)
    for s in q:
        assert s["start"] <= pushed and s["end"] - s["start"] >= 30e6
        wait = next(w for w in spans if w["name"] == "runtime.source_wait"
                    and w["block"] == s["block"])
        assert wait["start"] <= s["end"] <= wait["end"]  # popped while the loop waited
    assert rec["counters"]["ring.high_water"] == 3 == ring.stats["high_water"]
    assert ring.last_push_ns == q[-1]["start"]
    assert trace.summarize(rec)["spans"]["ring.queue"]["n"] == 3


def test_ring_high_water_without_tracing():
    ring = native.IngestRing(block_bytes=64, n_slots=3)
    b = np.zeros(64, np.uint8)
    for n in (2, 1, 3):
        for _ in range(n):
            ring.push(b)
        while ring.pop_raw(timeout_ms=10) is not None:
            pass
    assert ring.stats["high_water"] == 3 and ring.stats["depth"] == 0
    assert ring.last_push_ns > 0


def test_hold_through_two_block_source(rx, raw):
    """Block 0's audio leaves only once block 1 has arrived."""

    def blocks():
        yield raw[0]
        time.sleep(0.2)
        yield raw[1]

    trace.enable()
    _run(rx, blocks())
    rec = trace.snapshot()
    hold = trace.holds_ns(rec)
    assert set(hold) == {0, 1}
    assert hold[0] >= 0.2e9 and hold[1] < 0.2e9
    wait = [s for s in _spans(rec) if s["name"] == "runtime.source_wait" and s["block"] == 1]
    assert wait[0]["end"] - wait[0]["start"] >= 0.2e9
    assert trace.summarize(rec)["hold_p50_ms"] >= 100


def _order(rec):
    """The spans as (name, block, parent's name), in the order they began."""
    spans = _spans(rec)
    names = {s["seq"]: s["name"] for s in spans}
    return [(s["name"], s["block"], names.get(s["parent"])) for s in spans]


def test_publish_early_while_the_next_block_is_not_waiting(rx, raw):
    """A source whose hook says its next block is not there yet, as it
    sleeps 0.2 s: block 0 is delivered before the loop waits for block 1.
    Once the sleep is over the hook answers "waiting", so block 1 alone is
    held, to the source's end."""
    arrived = []

    def blocks():
        yield raw[0]
        time.sleep(0.2)
        arrived.append(1)
        yield raw[1]

    def source_ready():
        return bool(arrived)

    held = _run(rx, raw[:2])
    tr = trace.enable()
    got = []
    m = runtime.run_pipeline(rx, blocks(), lambda o: got.append(o) or 3, raw_u8=True,
                             source_ready=source_ready)
    rec = trace.snapshot()
    spans = _spans(rec)
    deliver = next(s for s in spans if s["name"] == "runtime.deliver" and s["block"] == 0)
    wait = next(s for s in spans if s["name"] == "runtime.source_wait" and s["block"] == 1)
    assert wait["end"] - wait["start"] >= 0.15e9
    assert deliver["start"] < wait["end"] and deliver["end"] <= wait["start"]
    hold = trace.holds_ns(rec)
    assert set(hold) == {0, 1} and all(h < 0.2e9 for h in hold.values()), hold
    # block 0 inside its own iteration; block 1 after the loop
    parents = {(n, b): p for n, b, p in _order(rec)}
    assert parents[("runtime.deliver", 0)] == "runtime.block"
    assert parents[("runtime.deliver", 1)] is None
    assert tr.counters["runtime.published_early"] == 1 == m.published_early
    assert m.summary()["published_early"] == 1 and m.messages_sent == 6
    # the same outputs, element for element, as the run that holds each block
    assert len(got) == len(held) == 2
    for a, b in zip(got, held):
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


def test_a_source_always_waiting_keeps_the_hold(rx, raw):
    """A hook that always answers "waiting" runs the spans in the order of
    a plain iterable: every block published in the next one's iteration."""
    trace.enable()
    plain = _run(rx, raw[:4])
    want = _order(trace.snapshot())
    tr = trace.enable()
    got = []
    m = runtime.run_pipeline(rx, iter(raw[:4]), lambda o: got.append(o) or 0, raw_u8=True,
                             source_ready=lambda: True)
    assert _order(trace.snapshot()) == want
    assert tr.counters["runtime.published_early"] == 0 == m.summary()["published_early"]
    for a, b in zip(got, plain):
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


def test_paced_block_is_delivered_before_its_sleep(rx, raw, monkeypatch):
    """Under ``realtime_fs`` a block is published as soon as it is on the
    host, while its next deadline is ahead: each callback comes before the
    pacing sleep that follows its block."""
    events = []

    class Clock:
        monotonic, monotonic_ns = staticmethod(time.monotonic), staticmethod(time.monotonic_ns)

        @staticmethod
        def sleep(s):
            events.append(("sleep", s))  # not slept: every deadline stays ahead

    monkeypatch.setattr(runtime, "time", Clock)

    def sink(outs):
        events.append(("deliver",))
        return 1

    tr = trace.enable()
    m = runtime.run_pipeline(rx, iter(raw[:4]), sink, raw_u8=True, realtime_fs=BLOCK)
    assert [e[0] for e in events] == ["deliver", "sleep"] * 4
    assert all(e[1] > 0 for e in events if e[0] == "sleep")
    assert m.published_early == 4 == tr.counters["runtime.published_early"]
    assert m.summary()["pacing_slack_ms"]["behind_blocks"] == 0 and m.messages_sent == 4


def test_egress_publish_is_a_child_of_deliver(rx, raw):
    from sdrreceiver_tpu_torch.io import zmqpub

    class Quiet:
        def publish(self, topic, rate, payload):
            pass

    hub = zmqpub.EgressHub(rx.plan)
    hub._route = {k: Quiet() for k in rx.rates() if k.startswith("audio/")}
    hub.rates = {k: 12000 for k in hub._route}
    trace.enable()
    runtime.run_pipeline(rx, iter(raw[:3]), hub.publish_outputs, raw_u8=True)
    spans = _spans(trace.snapshot())
    by_seq = {s["seq"]: s for s in spans}
    pub = [s for s in spans if s["name"] == "egress.publish"]
    assert [s["block"] for s in pub] == [0, 1, 2]
    for s in pub:
        p = by_seq[s["parent"]]
        assert p["name"] == "runtime.deliver" and p["block"] == s["block"]
        assert p["start"] <= s["start"] <= s["end"] <= p["end"]


def test_step_captures_one_per_entry(rx, raw, monkeypatch):
    tr = trace.enable()
    graphs = cudagraph.StepGraphs(rx)
    st = rx.init_state()
    st, _ = graphs.step(st, torch.from_numpy(raw[0]))
    assert not graphs.captures and "step.captures" not in tr.counters  # the CPU captures none
    monkeypatch.setattr(cudagraph.StepGraphs, "captures", property(lambda self: True))
    monkeypatch.setattr(cudagraph.StepGraphs, "_capture",
                        lambda self, inp, raw, body: cudagraph._Entry(inp, body))
    graphs = cudagraph.StepGraphs(rx)
    st = rx.init_state()
    for _ in range(2):  # two entries (a block, a burst of 2), each built once
        st, _ = graphs.step(st, torch.from_numpy(raw[0]))
        st, _ = graphs.step(st, torch.from_numpy(raw[:2].copy()))
    rec = trace.snapshot()
    caps = [s for s in _spans(rec) if s["name"] == "step.capture"]
    assert rec["counters"]["step.captures"] == 2 == len(caps)
    assert all(s["parent"] == -1 and s["block"] == -1 for s in caps)
    assert rec["counters"]["step.capture_ns"] == sum(s["end"] - s["start"] for s in caps) > 0


def test_step_start_event_follows_the_hosts_part(rx, raw, events, monkeypatch):
    """A graph step records the block's step-start event directly before
    its input copy, after the host's own part of the step (here a
    write-back held 20 ms): that host time lies between the H2D and the
    step's intervals, where the timeline shows it as idle."""
    monkeypatch.setattr(cudagraph.StepGraphs, "captures", property(lambda self: True))
    monkeypatch.setattr(cudagraph.StepGraphs, "_capture",
                        lambda self, inp, raw, body: cudagraph._Entry(inp, body))
    write_back = cudagraph.write_back

    def slow(dst, new, outputs=None):
        if outputs is None:  # the step's write-back, not the body's
            time.sleep(0.02)
        return write_back(dst, new, outputs)

    monkeypatch.setattr(cudagraph, "write_back", slow)
    monkeypatch.setattr(rx, "_graphs", cudagraph.StepGraphs(rx))
    trace.enable()
    _run(rx, raw[:3])
    rec = trace.snapshot()
    d = trace.device_intervals(rec)
    ev = d["events"]
    assert d["block"].tolist() == [0, 1, 2]
    assert ((ev[:, 2] - ev[:, 1]) >= 20e6).all()
    # each block's gap after its H2D copy is the held host time, named so
    gaps = {a: (b, n) for a, b, n in trace.idle_gaps(rec)}
    for e in ev:
        end, name = gaps[e[1]]
        assert end == e[2] and name == "step.enqueue"
    assert trace.idle_share(rec) > 0


def test_record_is_bounded_and_keeps_the_newest(rx, raw, events):
    tr = trace.enable(spans=16, device=2, samples=4)
    _run(rx, raw[:5])
    for i in range(6):
        tr.count("x", i)
    rec = trace.snapshot()
    seqs = rec["spans"]["seq"]
    assert seqs == sorted(seqs) and seqs[0] >= tr.n - 16
    assert len(seqs) <= 16 and seqs[-1] == tr.n - 1 and rec["spans_lost"] == tr.n - 16
    assert rec["device"]["block"] == [3, 4] and rec["device_lost"] == 3
    assert rec["samples"]["value"] == [2, 3, 4, 5]
    assert len(tr._start) == 16  # preallocated, never grown


def test_timeline_calibration_moves_to_a_recent_block(rx, raw, events, monkeypatch):
    """With the calibration older than ``REANCHOR_NS``, a block's first
    event becomes the new calibration (a fresh event takes its place in the
    set), and positions stay on the host clock."""
    monkeypatch.setattr(trace, "REANCHOR_NS", 0)
    calibrate, bracket = trace.Tracer.calibrate, []

    def timed(self):  # the calibration's host time is good to half its bracket
        t0 = time.monotonic_ns()
        calibrate(self)
        bracket.append(time.monotonic_ns() - t0)

    monkeypatch.setattr(trace.Tracer, "calibrate", timed)
    tr = trace.enable()
    _run(rx, raw[:4])
    cal, t_cal = tr._cal
    ev = trace.device_intervals(trace.snapshot())["events"]
    assert t_cal == ev[-1, 0] and cal.t is not None
    assert events.made == tr.events_made <= 1 + 2 * trace.EVENTS + 4  # a fresh event a block
    assert (np.diff(ev, axis=1) >= 0).all() and (ev[1:, 0] >= ev[:-1, -1]).all()
    # the fake's events read the host clock: positions are that clock's
    assert abs(ev[-1, 0] - cal.t) <= bracket[0] / 2 + 1


def test_timeline_names_the_callback_for_idle_time(rx, raw, events):
    """A callback that sleeps leaves the stream idle while the host
    delivers: the timeline's gaps are named ``runtime.deliver``."""
    tr = trace.enable()
    _run(rx, raw[:5], cb=lambda outs: time.sleep(0.03) or 0)
    rec = trace.snapshot()
    d = trace.device_intervals(rec)
    assert d["block"].tolist() == [0, 1, 2, 3, 4] and tr.events_made <= 1 + 2 * trace.EVENTS
    ev = d["events"]
    assert (np.diff(ev, axis=1) >= 0).all() and (ev[1:, 0] >= ev[:-1, -1]).all()
    s = trace.summarize(rec)
    idle = s["idle_s_by_span"]
    assert max(idle, key=idle.get) == "runtime.deliver" and idle["runtime.deliver"] >= 0.1
    assert 0 < s["device_idle_share"] < 1
    for a, b, label in trace.idle_gaps(rec):
        assert a < b and isinstance(label, str)


# ------------------------------------------------------------ exporter
@pytest.mark.parametrize("command", ["process-file", "run"])
def test_trace_out_exports_chrome_json(rx, tmp_path, capsys, command):
    plan = rx.plan
    ini = tmp_path / "rx.ini"
    ini.write_text(_to_ini(altrate_config()))
    iq = synthesize_channels(3 * BLOCK, plan.fs, plan.center_frequency, [], noise=0.5, seed=7)
    iqfile.write_iq(tmp_path / "rec.u8", iq, "u8")
    out = tmp_path / "trace.json"
    argv = [command, "-s", ini, "--iq", tmp_path / "rec.u8", "--device", "cpu", "--block", BLOCK,
            "--max-blocks", 3, "--trace-out", out]
    argv += ["--out", tmp_path / "o"] if command == "process-file" else ["--fast"]
    assert main([str(a) for a in argv]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert trace.current() is None
    assert summary["trace"]["spans"]["runtime.block"]["n"] == 3
    assert summary["trace"]["spans"]["runtime.deliver"]["p50_ms"] >= 0
    doc = json.loads(out.read_text())
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert {e["name"] for e in xs} >= set(PER_BLOCK)
    assert all(e["dur"] >= 0 and "block" in e["args"] for e in xs)
    host = [e for e in xs if e["tid"] == 1]
    parents = {}
    for e in host:
        parents.setdefault(e["args"]["parent"] or ("top", e["name"]), []).append(e)
    blocks = parents[("top", "runtime.block")]
    assert [e["args"]["block"] for e in blocks] == [0, 1, 2]
    for e in blocks:  # a block's children are ordered, disjoint and inside it
        kids = sorted((k for k in host if k["args"]["parent"] == "runtime.block"
                       and e["ts"] <= k["ts"] <= e["ts"] + e["dur"]), key=lambda k: k["ts"])
        assert kids[0]["name"] == "runtime.source_wait"
        for a, b in zip(kids, kids[1:]):
            assert a["ts"] + a["dur"] <= b["ts"] + 1e-3
    for a, b in zip(blocks, blocks[1:]):
        assert a["ts"] + a["dur"] <= b["ts"] + 1e-3


def test_enable_is_per_process_state():
    tr = trace.enable()
    seen = []
    t = threading.Thread(target=lambda: seen.append(trace.current()))
    t.start()
    t.join(timeout=5)
    assert not t.is_alive() and seen == [tr]
    trace.disable()
    assert trace.current() is None and trace.snapshot() is None


# ------------------------------------------------------------ readings
MS = 1_000_000  # ns


def _record():
    """Blocks 0-3, 10 ms apart.  Block b: a step enqueue that ends 4 ms in,
    its fetch (b + 1) * 0.1 ms long and its delivery in the next block's
    iteration, from 14 ms (a 10 ms hold), a ring queue of (b + 1) ms;
    device: H2D 0.01, a 0.04 gap, step 0.5, a 0.2 gap, D2H 0.02 ms."""
    names, start, end, block = [], [], [], []

    def add(n, t0, t1, b):
        names.append(n), start.append(int(t0)), end.append(int(t1)), block.append(b)

    events = []
    for b in range(4):
        t = b * 10 * MS
        add("runtime.block", t, t + 9 * MS, b)
        add("ring.queue", t - (b + 1) * MS, t, b)
        add("step.enqueue", t + MS, t + 4 * MS, b)
        add("runtime.fetch_wait", t + 14 * MS - (b + 1) * MS // 10, t + 14 * MS, b)
        add("runtime.deliver", t + 14 * MS, t + 15 * MS, b)
        e0 = t + 0.9 * MS
        events.append([e0 + x * MS for x in (0, 0.01, 0.05, 0.55, 0.75, 0.77)])
    n = len(names)
    return {"spans": {"seq": list(range(n)), "name": names, "start": start, "end": end,
                      "parent": [-1] * n, "block": block},
            "spans_lost": 0, "device": {"block": [0, 1, 2, 3], "events": events},
            "device_lost": 0, "counters": {}}


@pytest.mark.parametrize("blocks", [None, (1, 2)])
def test_readings_of_the_blocks_given(blocks):
    rec = _record()
    read = range(4) if blocks is None else blocks
    assert trace.durations_ns(rec, "ring.queue", blocks).tolist() == [(b + 1) * MS for b in read]
    assert trace.durations_ns(rec, "runtime.fetch_wait", blocks).tolist() == [
        (b + 1) * MS // 10 for b in read]
    assert trace.holds_ns(rec, blocks) == {b: 10 * MS for b in read}
    d = trace.device_intervals(rec, blocks)
    assert d["block"].tolist() == list(read)
    np.testing.assert_allclose(d["h2d"], 0.01 * MS)
    np.testing.assert_allclose(d["step"], 0.5 * MS)
    np.testing.assert_allclose(d["d2h"], 0.02 * MS)
    np.testing.assert_allclose(d["busy"], 0.53 * MS)
    # only periods whose next block is read too: block 3 (2) has no next one
    assert d["next"].tolist() == [b + 1 in read for b in read]
    assert trace.idle_share(rec, blocks) == pytest.approx(1 - 0.53 / 10)


def test_idle_share_none_without_a_whole_period():
    rec = _record()
    assert trace.idle_share(rec, (3,)) is None and trace.idle_share(rec, ()) is None
    assert trace.holds_ns(rec, ()) == {} and len(trace.durations_ns(rec, "ring.queue", ())) == 0


def test_summary_reads_the_same_as_the_readings():
    rec = _record()
    rec["samples"] = {"name": [], "t": [], "value": []}
    s = trace.summarize(rec)
    assert s["device_idle_share"] == pytest.approx(trace.idle_share(rec), abs=1e-5)
    assert s["hold_p50_ms"] == pytest.approx(10.0)
    assert s["spans"]["ring.queue"]["p50_ms"] == pytest.approx(2.5)
    assert s["device_us_p50"] == pytest.approx({"h2d": 10.0, "step": 500.0, "d2h": 20.0})
    # a block's gaps: after its H2D (before its step.enqueue begins), after
    # its step (inside step.enqueue) and to the next block's H2D
    labels = [label for _, _, label in trace.idle_gaps(rec)]
    assert labels == ["runtime.block", "step.enqueue", "runtime.block"] * 3 + [
        "runtime.block", "step.enqueue"]

