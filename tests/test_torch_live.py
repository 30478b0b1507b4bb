"""The port's live path (rtl_tcp, native ring, local USB, control socket,
live scope, ``run``/``devices``/``bench``) against the JAX package's.

Host modules are compared exactly: the command bytes an rtl_tcp server
receives, ring contents, LUT output, control replies, the scope's fetch
cadence; the scope's spectrum to 1e-3 dB.  ``run`` is driven in this
process over a loopback rtl_tcp server, a looped recording and the
librtlsdr stub (``tests/fake_librtlsdr.cpp``) on ``--device cpu``, with a
ZMQ subscriber connected before it starts; its audio is held bit-equal to
the port's own ``step_u8`` on the same bytes and within 1 LSB (flip rate
< 1e-3) of the JAX ``run`` on the same stream.  Every ZMQ port comes from
``_free_port()``, and every ``run`` goes through :func:`_within`: a call
that has not returned after ``RUN_LIMIT`` seconds fails its test instead of
holding the whole run.
"""

import contextlib
import ctypes
import json
import pathlib
import socket
import struct
import subprocess
import threading
import time

import numpy as np
import pytest
import torch

from sdrreceiver_tpu.cli.control import ControlServer as JControlServer
from sdrreceiver_tpu.cli.main import main as jmain
from sdrreceiver_tpu.io import native as jnative
from sdrreceiver_tpu.io import rtlusb as jrtlusb
from sdrreceiver_tpu.io import rtltcp as jrtltcp
from sdrreceiver_tpu.obs.spectrum import LiveScope as JLiveScope
from sdrreceiver_tpu_torch.cli.control import ControlServer
from sdrreceiver_tpu_torch.cli.main import main
from sdrreceiver_tpu_torch.graph.compiler import CompiledReceiver
from sdrreceiver_tpu_torch.graph.config import parse_ini_text
from sdrreceiver_tpu_torch.graph.plan import build_plan
from sdrreceiver_tpu_torch.io import iqfile, native, rtlusb, rtltcp
from sdrreceiver_tpu_torch.obs.spectrum import LiveScope
from test_torch_cli import _free_port

# six xdist workers share the machine's cores: a few torch threads each
torch.set_num_threads(2)

TESTS = pathlib.Path(__file__).resolve().parent
REPO = TESTS.parent
BLOCK = 49152
#: seconds a ``run`` may take before its test fails (a few blocks on the CPU
#: take seconds; the JAX run also compiles its step)
RUN_LIMIT = 240.0


def _within(seconds: float, fn, *args):
    """``fn(*args)`` on a thread of its own, joined with a deadline: its
    value, or its exception raised here; a call still running after
    ``seconds`` fails the test (the thread is a daemon and is left
    behind)."""
    box: dict = {}

    def go():
        try:
            box["value"] = fn(*args)
        except BaseException as e:  # noqa: BLE001 - re-raised on the test's thread
            box["error"] = e

    t = threading.Thread(target=go, daemon=True)
    t.start()
    t.join(seconds)
    if t.is_alive():
        pytest.fail(f"{getattr(fn, '__module__', '')}.{getattr(fn, '__name__', fn)}{args[:1]} "
                    f"still running after {seconds:.0f} s")
    if "error" in box:
        raise box["error"]
    return box["value"]

# tests/test_io_cli.py's MINI_INI on a port of its own
MINI_INI = """
sample_rate=1536000
center_frequency=1545600000
zmq_address=tcp://127.0.0.1:{port}
correct_dc_bias=1
[main_vfos]
size=1
1\\frequency=1545116000
1\\out_rate=384000
[vfos]
size=1
1\\frequency=1545005146
1\\gain=5
1\\data_rate=600
1\\topic=VFO01
"""


def _mini(port: int, remote: str = "") -> str:
    head = f"remote_rtl={remote}\n" if remote else ""
    return head + MINI_INI.format(port=port)


def _read_cmds(conn, n: int) -> list[tuple[int, int]]:
    got = b""
    while len(got) < 5 * n:
        chunk = conn.recv(5 * n - len(got))
        if not chunk:
            break
        got += chunk
    return [(got[i], struct.unpack(">I", got[i + 1 : i + 5])[0]) for i in range(0, len(got), 5)]


class _RtlServer(threading.Thread):
    """Loopback rtl_tcp server.  Connection i: greeting, read ``n_cmds``
    5-byte commands, wait ``delay`` s, send ``payloads[i]``, then either
    close (a mid-stream drop) or, with ``hold``, keep the stream alive
    with one byte every 0.5 s (never a whole block: no reader timeout, no
    extra block) until the client leaves."""

    def __init__(self, payloads, n_cmds=5, delay=0.0, hold=False):
        super().__init__(daemon=True)
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(1)
        self.port = self.sock.getsockname()[1]
        self.payloads, self.n_cmds, self.delay, self.hold = payloads, n_cmds, delay, hold
        self.commands: list[list[tuple[int, int]]] = []
        self.start()

    def run(self):
        for data in self.payloads:
            conn, _ = self.sock.accept()
            with conn:
                conn.sendall(b"RTL0" + struct.pack(">II", 5, 29))
                self.commands.append(_read_cmds(conn, self.n_cmds))
                time.sleep(self.delay)
                with contextlib.suppress(OSError):
                    conn.sendall(data)
                    deadline = time.monotonic() + 120
                    while self.hold and time.monotonic() < deadline:
                        time.sleep(0.5)
                        conn.sendall(b"\x7f")
                    if not self.hold:
                        time.sleep(0.05)
        self.sock.close()


# ------------------------------------------------------------- rtl_tcp
@pytest.mark.parametrize("gain,agc", [(7, False), (0, True)])
def test_rtl_tcp_command_bytes_equal_jax(gain, agc):
    """configure + a retune, as captured by a server, from both clients."""
    got = {}
    for name, mod in (("port", rtltcp), ("jax", jrtltcp)):
        srv = _RtlServer([bytes(range(256)) * 16], n_cmds=6)
        cli = mod.RtlTcpClient(f"127.0.0.1:{srv.port}")
        assert cli.greeting == mod.Greeting(5, 29)
        cli.configure(1536000, 1545600000, gain_index=gain, agc=agc)
        cli.set_center_freq(1545700000)
        block = cli.read_block(4096)
        assert block.dtype == np.uint8 and block.shape == (4096,)
        np.testing.assert_array_equal(block[:256], np.arange(256, dtype=np.uint8))
        cli.close()
        srv.join(timeout=5)
        got[name] = srv.commands[0]
    assert got["port"] == got["jax"]
    assert got["port"][0] == (rtltcp.CMD.SET_AGC_MODE, int(agc))
    assert got["port"][-1] == (rtltcp.CMD.SET_FREQ, 1545700000)


@pytest.mark.parametrize("case", ["bad_magic", "bad_address"])
def test_rtl_tcp_errors_equal_jax(case):
    def connect(mod):
        if case == "bad_address":
            return mod.RtlTcpClient("localhost")
        srv = socket.socket()
        srv.bind(("127.0.0.1", 0))
        srv.listen(1)

        def serve():
            conn, _ = srv.accept()
            conn.sendall(b"JUNK" + b"\x00" * 8)
            time.sleep(0.2)
            conn.close()
            srv.close()

        threading.Thread(target=serve, daemon=True).start()
        return mod.RtlTcpClient(f"127.0.0.1:{srv.getsockname()[1]}")

    errs = {}
    for name, mod in (("port", rtltcp), ("jax", jrtltcp)):
        with pytest.raises((IOError, ValueError)) as ei:
            connect(mod)
        errs[name] = (type(ei.value), str(ei.value))
    assert errs["port"] == errs["jax"]


def _stamped(conn_i: int, n: int) -> bytes:
    """Bytes stamped with the connection index (high nibble) and a phase
    counter (low nibble)."""
    return bytes(((conn_i << 4) | (j % 16)) for j in range(n))


def test_elastic_reconnects_and_realigns():
    """A server that drops every connection mid-block: the port's elastic
    client reconnects, replays the configure sequence, and yields whole
    blocks, each from one connection's stream start onward (the JAX
    package's test_reconnects_and_realigns)."""
    srv = _RtlServer([_stamped(i, 3000) for i in range(3)])
    cli = rtltcp.ElasticRtlTcp(f"127.0.0.1:{srv.port}", initial_backoff=0.01,
                               max_backoff=0.05, max_retries=200)
    cli.configure(1536000, 1545600000, gain_index=7)
    blocks = [cli.read_block(1024) for _ in range(6)]
    cli.close()
    srv.join(timeout=5)
    assert cli.stats["reconnects"] == 2 and cli.closed
    seen = []
    for b in blocks:
        stamps = set((b >> 4).tolist())
        assert len(stamps) == 1, "block mixes bytes from two connections"
        seen.append(stamps.pop())
        np.testing.assert_array_equal(b & 0x0F, np.arange(1024) % 16)
    assert seen == [0, 0, 1, 1, 2, 2]
    assert len(srv.commands) == 3 and all(c == srv.commands[0] for c in srv.commands)


def test_elastic_replays_retune_like_jax():
    """After a drop, the second connection gets the configure sequence and
    then the last retune, from both packages' elastic clients."""
    got = {}
    for name, mod in (("port", rtltcp), ("jax", jrtltcp)):
        srv = _RtlServer([_stamped(0, 2048), _stamped(1, 2048)], n_cmds=6)
        cli = mod.ElasticRtlTcp(f"127.0.0.1:{srv.port}", initial_backoff=0.01, max_retries=200)
        cli.configure(1536000, 1545600000, gain_index=3)
        cli.set_center_freq(1545700000)
        assert set((cli.read_block(2048) >> 4).tolist()) == {0}
        assert set((cli.read_block(2048) >> 4).tolist()) == {1}  # crossed the drop
        cli.close()
        srv.join(timeout=5)
        assert cli.stats["reconnects"] == 1
        got[name] = srv.commands
    assert got["port"] == got["jax"]
    assert got["port"][1] == got["port"][0]
    assert got["port"][1][-1] == (rtltcp.CMD.SET_FREQ, 1545700000)


# ---------------------------------------------------------- native ring
# What the port's ring adds to the JAX package's source, for tracing: (the
# JAX source's line before which it goes, the lines added).
RING_ADDITIONS = (
    (14, "//\n"
         "// Each slot carries its push time on steady_clock (CLOCK_MONOTONIC on Linux,\n"
         "// the clock of Python's time.monotonic_ns), read back after a pop as\n"
         "// rb_last_push_ns; high_water is the most slots ever full at once.\n"),
    (32, "  std::vector<int64_t> pushed_ns;  // each slot's push time, steady_clock ns\n"
         "  int64_t last_push_ns = 0;        // push time of the last slot popped (consumer only)\n"),
    (35, "  int high_water = 0;  // guarded by mu\n"),
    (43, "    pushed_ns.assign(slots, 0);\n"),
    (48, "\n"
         "int64_t now_ns() {\n"
         "  return std::chrono::duration_cast<std::chrono::nanoseconds>(\n"
         "             std::chrono::steady_clock::now().time_since_epoch())\n"
         "      .count();\n"
         "}\n"),
    (84, "    rb->pushed_ns[slot_idx] = now_ns();\n"),
    (86, "    if (rb->count > rb->high_water) rb->high_water = rb->count;\n"),
    (110, "    rb->last_push_ns = rb->pushed_ns[slot_idx];\n"),
    (140, "    rb->last_push_ns = rb->pushed_ns[slot_idx];\n"),
    (171, "int rb_stat_high_water(void* h) {\n"
          "  auto* rb = static_cast<RingBuffer*>(h);\n"
          "  std::lock_guard<std::mutex> lk(rb->mu);\n"
          "  return rb->high_water;\n"
          "}\n"
          "// Push time (steady_clock ns) of the block the last successful pop returned;\n"
          "// call from the consumer's thread.\n"
          "int64_t rb_last_push_ns(void* h) { return static_cast<RingBuffer*>(h)->last_push_ns; }\n"),
)


def test_ringbuffer_source_identical_and_built_in_build_dir():
    """The port's ring is the JAX package's source byte for byte with the
    push times and the high-water depth of ``RING_ADDITIONS`` inserted;
    nothing of the JAX source is changed or left out."""
    ours = (REPO / "sdrreceiver_tpu_torch" / "io" / "native" / "ringbuffer.cpp").read_bytes()
    ref = (REPO / "sdrreceiver_tpu" / "io" / "native" / "ringbuffer.cpp").read_bytes()
    lines = ref.decode().splitlines(keepends=True)
    for at, added in reversed(RING_ADDITIONS):
        lines[at:at] = [added]
    assert "".join(lines).encode() == ours
    assert native.available()
    assert pathlib.Path(native.load_library()._name).parent == REPO / "build"


def test_u8_to_f32_equal_jax(rng):
    raw = rng.integers(0, 256, 4099).astype(np.uint8)
    ours = native.u8_to_f32(raw)
    np.testing.assert_array_equal(ours, jnative.u8_to_f32(raw))
    np.testing.assert_array_equal(ours, raw.astype(np.float32) - 127.0)


@pytest.mark.parametrize("pop", ["pop_raw", "pop_f32"])
def test_ring_push_pop(rng, pop):
    ring = native.IngestRing(block_bytes=1024, n_slots=4)
    blocks = [rng.integers(0, 256, 1024).astype(np.uint8) for _ in range(3)]
    for b in blocks:
        assert ring.push(b) == 0
    for b in blocks:
        got = getattr(ring, pop)(timeout_ms=1000)
        want = b if pop == "pop_raw" else b.astype(np.float32) - 127.0
        np.testing.assert_array_equal(got, want)
    assert ring.stats == {"pushed": 3, "popped": 3, "dropped": 0, "depth": 0, "high_water": 3}
    ring.close()
    assert ring.push(blocks[0]) == -1 and getattr(ring, pop)(timeout_ms=100) is None


def test_ring_drops_on_full_and_times_out(rng):
    ring = native.IngestRing(block_bytes=64, n_slots=2)
    b = rng.integers(0, 256, 64).astype(np.uint8)
    assert [ring.push(b) for _ in range(3)] == [0, 0, 1]  # jonti/sdr.cpp:104-111
    assert ring.stats["dropped"] == 1 and ring.stats["depth"] == 2
    for _ in range(2):
        assert ring.pop_raw(timeout_ms=100) is not None
    t0 = time.monotonic()
    assert ring.pop_raw(timeout_ms=100) is None
    assert 0.05 < time.monotonic() - t0 < 2.0
    ring.close()


def test_ring_depth_equals_the_stats_depth(rng):
    """``depth()`` reads what ``stats["depth"]`` reads, through pushes, a
    push dropped on a full ring, and pops."""
    ring = native.IngestRing(block_bytes=64, n_slots=3)
    b = rng.integers(0, 256, 64).astype(np.uint8)
    seen = []

    def look():
        assert ring.depth() == ring.stats["depth"]
        seen.append(ring.depth())

    look()
    for _ in range(4):
        ring.push(b)
        look()
    for _ in range(3):
        assert ring.pop_raw(timeout_ms=100) is not None
        look()
    assert seen == [0, 1, 2, 3, 3, 2, 1, 0] and ring.stats["dropped"] == 1
    ring.close()


def test_ring_producer_consumer_threads(rng):
    """50 blocks through an 8-slot ring from a producer thread that retries
    a dropped push: every block arrives, in order."""
    ring = native.IngestRing(block_bytes=2048, n_slots=8)
    blocks = [rng.integers(0, 256, 2048).astype(np.uint8) for _ in range(50)]

    def producer():
        for b in blocks:
            while ring.push(b) == 1:
                time.sleep(0.0005)
        ring.close()

    t = threading.Thread(target=producer)
    t.start()
    got = []
    while (out := ring.pop_raw(timeout_ms=2000)) is not None:
        got.append(out)
    t.join(timeout=10)
    assert not t.is_alive() and len(got) == 50
    for g, b in zip(got, blocks):
        np.testing.assert_array_equal(g, b)


# ------------------------------------------------------- control, scope
class _Tuner:
    def __init__(self):
        self.freq = None

    def set_center_freq(self, f):
        self.freq = f


def _scope_frames(seed: int, n: int) -> list[np.ndarray]:
    r = np.random.default_rng(seed)
    t = np.arange(8192)
    return [np.stack([np.cos(2 * np.pi * 0.1 * t), np.sin(2 * np.pi * 0.1 * t)]).astype(np.float32)
            * 40 + r.standard_normal((2, 8192)).astype(np.float32) for _ in range(n)]


def test_control_replies_equal_jax():
    """The same command sequence to both servers, each over a tuner and a
    live scope fed the same frames: the same replies (the spectrum's dB
    list within 0.01 dB, its 2-decimal rounding)."""
    cmds = [b'{"set_center_freq": 1545601000}', b'{"stats": true}', b'{"spectrum": 64}',
            b'{"spectrum": 5000}', b"not json",
            b'{"bogus": 1}', b'{"set_center_freq": "junk"}', b'{"set_bias_tee": 1}',
            b'{"set_scope": "VFO01"}', b'{"set_scope": "BAD"}', b'{"set_fft": 0}',
            b'{"set_fft": 1}', b'{"set_scope": "main"}', b'{"set_scope": "off"}']
    replies, tuners = {}, {}
    for name, srv_cls, scope_cls in (("port", ControlServer, LiveScope),
                                     ("jax", JControlServer, JLiveScope)):
        scope = scope_cls({"main": 1536000, "VFO01": 12000}, initial="main")
        for i, f in enumerate(_scope_frames(0, 11)):
            scope.observe({"tap/main": f})
        tuners[name] = _Tuner()
        srv = srv_cls(0, rtl_client=tuners[name], stats_fn=lambda: {"blocks": 7},
                      commands={"set_scope": scope.set_scope, "set_fft": scope.set_fft,
                                "spectrum": scope.snapshot})
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        sock.settimeout(5)
        replies[name] = []
        try:
            for c in cmds:
                sock.sendto(c, ("127.0.0.1", srv.port))
                replies[name].append(json.loads(sock.recv(65536)))
        finally:
            srv.close()
            sock.close()
    assert tuners["port"].freq == tuners["jax"].freq == 1545601000
    for c, a, b in zip(cmds, replies["port"], replies["jax"]):
        if c.startswith(b'{"spectrum"'):
            assert {k: v for k, v in a.items() if k != "db"} == {k: v for k, v in b.items() if k != "db"}
            np.testing.assert_allclose(a["db"], b["db"], rtol=0, atol=0.0101)
            assert len(a["db"]) == a["bins"] and max(a["db"]) > 1  # three frames in
        else:
            assert a == b, c


def test_scope_cadence_and_snapshot_equal_jax():
    """The same output stream and the same switches: ``wants`` answers the
    same per block (every 5th, active tap only), and the smoothed curve
    ends within 1e-3 dB of JAX's."""
    taps = {"main": 1536000, "g0": 384000, "VFO01": 12000}
    ours, ref = LiveScope(taps, initial="main"), JLiveScope(taps, initial="main")
    frames = _scope_frames(1, 23)
    trace = {"port": [], "jax": []}
    for i, f in enumerate(frames):
        if i == 9:
            assert ours.set_scope("g0") == ref.set_scope("g0")
        if i == 15:
            assert ours.set_fft(0) == ref.set_fft(0)
        if i == 17:
            assert ours.set_fft(1) == ref.set_fft(1)
        for name, sc in (("port", ours), ("jax", ref)):
            want = {k: sc.wants(k) for k in ("tap/main", "tap/g0", "tap/VFO01", "audio/VFO01")}
            trace[name].append(want)
            sc.observe({k: f for k, w in want.items() if w and k.startswith("tap/")})
    assert trace["port"] == trace["jax"]
    assert sum(t["tap/main"] for t in trace["port"]) == 2  # blocks 0 and 5
    np.testing.assert_allclose(ours.ema.smoothed, ref.ema.smoothed, rtol=0, atol=1e-3)
    a, b = ours.snapshot(512), ref.snapshot(512)
    assert a["bins"] == b["bins"] == 512 and a["scope"] == b["scope"] == "g0"
    np.testing.assert_allclose(a["db"], b["db"], rtol=0, atol=0.0101)


@pytest.fixture(scope="module")
def scope_receivers():
    """The port's and the JAX receiver with the main and VFO01 taps, built
    once for both cases (the JAX step compiles once)."""
    from sdrreceiver_tpu.graph.compiler import CompiledReceiver as JaxReceiver
    from sdrreceiver_tpu.graph.config import parse_ini_text as jparse
    from sdrreceiver_tpu.graph.plan import build_plan as jbuild_plan

    taps = ("main", "VFO01")
    return {
        "port": CompiledReceiver(build_plan(parse_ini_text(_mini(_free_port()))), BLOCK,
                                 emit_taps=taps, device="cpu"),
        "jax": JaxReceiver(jbuild_plan(jparse(_mini(_free_port()))), BLOCK, emit_taps=taps),
    }


@pytest.mark.parametrize("switch_in", ["callback", "source"])
def test_scope_through_run_pipeline_like_jax(switch_in, scope_receivers):
    """A live scope as ``run --scope`` wires it (``wants`` the fetch filter,
    ``observe`` in the callback), switched from main to VFO01 after block
    3's callback, either in that callback or while the source hands over
    block 5 (after block 4 is queued, before it is published: where a
    control thread's switch lands while ``run`` waits for the next block).
    Each block's delivered taps are the JAX runtime's, the switch is
    consumed at once, and the curves agree to 1e-2 dB (the taps themselves
    differ at float rounding)."""
    from sdrreceiver_tpu.core.runtime import run_pipeline as jrun_pipeline
    from sdrreceiver_tpu_torch.core.runtime import run_pipeline

    raw = _u8_stream(12, seed=4).reshape(12, -1)
    got, scopes = {}, {}
    for name, rx, run, scope_cls in (
        ("port", scope_receivers["port"], run_pipeline, LiveScope),
        ("jax", scope_receivers["jax"], jrun_pipeline, JLiveScope),
    ):
        scope = scopes[name] = scope_cls(rx.tap_rates(), initial="main")
        seen = got[name] = []

        def on_outputs(outs, scope=scope, seen=seen):
            seen.append(sorted(k for k in outs if k.startswith("tap/")))
            scope.observe(outs)
            if switch_in == "callback" and len(seen) == 4:
                scope.set_scope("VFO01")
            return 0

        def source(scope=scope):
            for i, blk in enumerate(raw):
                if switch_in == "source" and i == 5:
                    scope.set_scope("VFO01")
                yield blk

        run(rx, source(), on_outputs, raw_u8=True, fetch_filter=scope.wants)
    assert got["port"] == got["jax"]
    assert got["port"] == [["tap/main"], [], [], [], ["tap/VFO01"], [], [], [], [],
                           ["tap/VFO01"], [], []]
    a, b = scopes["port"].snapshot(512), scopes["jax"].snapshot(512)
    assert a["scope"] == b["scope"] == "VFO01" and max(a["db"]) > 1
    np.testing.assert_allclose(a["db"], b["db"], rtol=0, atol=1e-2)


# ----------------------------------------------------------- run (CLI)
def _u8_stream(n_blocks: int, seed: int = 0) -> np.ndarray:
    iq = iqfile.synthesize_channels(n_blocks * BLOCK, 1536000, 1545600000,
                                    [(1545005146, 1000.0, 1.0)], noise=0.5, seed=seed)
    return iqfile.to_u8(iq)


class _Sub:
    """A ZMQ SUB on ``port``, connected (and retrying every 10 ms until the
    publisher binds) before ``run`` starts; :meth:`collect` gathers up to
    ``n`` frames on a thread of its own.  A subscriber that joins late
    misses the first frames, so checks that need every frame pause the
    source until it has joined."""

    def __init__(self, port: int, topic: bytes = b"VFO01"):
        import zmq

        self.ctx = zmq.Context()
        self.sock = self.ctx.socket(zmq.SUB)
        self.sock.setsockopt(zmq.RECONNECT_IVL, 10)
        self.sock.connect(f"tcp://127.0.0.1:{port}")
        self.sock.setsockopt(zmq.SUBSCRIBE, topic)
        self.frames: list[list[bytes]] = []
        self._stop = threading.Event()
        self._thread = None

    def collect(self, n: int, timeout: float = 60.0) -> threading.Thread:
        def go():
            deadline = time.monotonic() + timeout
            while len(self.frames) < n and time.monotonic() < deadline and not self._stop.is_set():
                if self.sock.poll(50):
                    self.frames.append(self.sock.recv_multipart())

        self._thread = threading.Thread(target=go, daemon=True)
        self._thread.start()
        return self._thread

    def close(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self.sock.close(linger=0)
        self.ctx.term()


def _run_rtl_tcp(cli, ini_path: pathlib.Path, raw: bytes, zport: int, n_blocks: int, *extra):
    """``run`` of ``cli`` over a loopback rtl_tcp server that serves ``raw``
    once (after a pause for the subscriber), then one block of zeros, and
    holds the connection: (exit code, ZMQ frames, server commands).  The
    JAX runtime takes one block past ``--max-blocks`` before it stops; when
    it reads the socket itself (its native ring not built) it waits for
    that block, so the block is there."""
    srv = _RtlServer([raw + bytes(2 * BLOCK)], delay=1.0, hold=True)
    ini_path.write_text(_mini(zport, f"127.0.0.1:{srv.port}"))
    sub = _Sub(zport)
    t = sub.collect(n_blocks)
    try:
        rc = _within(RUN_LIMIT, cli, ["run", "-s", str(ini_path), "--block", str(BLOCK),
                                      "--max-blocks", str(n_blocks), *extra])
        t.join(timeout=30)
    finally:
        sub.close()
    srv.join(timeout=10)
    return rc, sub.frames, srv.commands[0]


def test_run_rtl_tcp_matches_step_u8_and_jax(tmp_path, capsys):
    """8 blocks over rtl_tcp (fewer than the ring's 20 slots: none drop):
    the port's ZMQ audio is bit-equal to its own step_u8 on those bytes and
    within 1 LSB of the JAX ``run`` over the same stream."""
    n = 8
    raw = _u8_stream(n)
    zport = _free_port()
    rc, frames, cmds = _run_rtl_tcp(main, tmp_path / "p.ini", raw.tobytes(), zport, n,
                                    "--device", "cpu")
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["blocks"] == n and summary["device"] == "cpu"
    assert summary["ring"]["dropped"] == 0 and summary["rtl_tcp"]["reconnects"] == 0
    assert [c[0] for c in cmds[:5]] == [0x08, 0x03, 0x0D, 0x02, 0x01]
    assert cmds[4] == (0x01, 1545600000)
    assert len(frames) == n
    for f in frames:
        assert len(f) == 3 and f[0] == b"VFO01" and struct.unpack("<I", f[1])[0] == 12000
    pcm = np.concatenate([np.frombuffer(f[2], np.int16) for f in frames])

    rx = CompiledReceiver(build_plan(parse_ini_text(_mini(zport))), BLOCK, device="cpu")
    state, direct = rx.init_state(), []
    for blk in raw.reshape(n, -1):
        state, o = rx.step_u8(state, torch.from_numpy(blk))
        direct.append(rx.split_audio(o)["audio/VFO01"].numpy())
    np.testing.assert_array_equal(pcm, np.concatenate(direct))

    rc, jframes, jcmds = _run_rtl_tcp(jmain, tmp_path / "j.ini", raw.tobytes(), _free_port(), n,
                                      "--backend", "cpu")
    capsys.readouterr()
    assert rc == 0 and jcmds == cmds and len(jframes) == n
    jpcm = np.concatenate([np.frombuffer(f[2], np.int16) for f in jframes])
    d = np.abs(pcm.astype(np.int32) - jpcm)
    assert d.max() <= 1 and (d > 0).mean() < 1e-3, (d.max(), (d > 0).mean())


def test_run_rtl_tcp_without_native_ring_reads_the_socket(tmp_path, capsys, monkeypatch):
    """Without the native library (``native.available()`` false, as when
    g++ cannot build it) ``run`` reads the socket on the pipeline thread,
    as the JAX CLI does: no ``ring`` in the summary, and the same audio,
    bit for bit, as ``step_u8`` on those bytes."""
    monkeypatch.setattr(native, "available", lambda: False)
    n = 4
    raw = _u8_stream(n, seed=1)
    zport = _free_port()
    rc, frames, cmds = _run_rtl_tcp(main, tmp_path / "p.ini", raw.tobytes(), zport, n,
                                    "--device", "cpu")
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["blocks"] == n and "ring" not in summary
    assert summary["rtl_tcp"]["reconnects"] == 0
    assert [c[0] for c in cmds[:5]] == [0x08, 0x03, 0x0D, 0x02, 0x01]
    assert len(frames) == n
    pcm = np.concatenate([np.frombuffer(f[2], np.int16) for f in frames])
    rx = CompiledReceiver(build_plan(parse_ini_text(_mini(zport))), BLOCK, device="cpu")
    state, direct = rx.init_state(), []
    for blk in raw.reshape(n, -1):
        state, o = rx.step_u8(state, torch.from_numpy(blk))
        direct.append(rx.split_audio(o)["audio/VFO01"].numpy())
    np.testing.assert_array_equal(pcm, np.concatenate(direct))


def test_run_iq_fast_frames_contiguous(tmp_path, capsys):
    """``run --iq --fast`` over a recording looped twice: every frame
    carries the exact topic and rate and one block's audio, and the frames
    joined are a contiguous stretch of the ``process-file`` audio of the
    looped recording, ending at the last block (no gap, overlap or
    re-order; a late subscriber misses only the first frames).  The JAX
    package's test_zmq_stream_contiguous_across_blocks, against the port."""
    zport = _free_port()
    ini = tmp_path / "m.ini"
    ini.write_text(_mini(zport))
    iq = tmp_path / "t.u8"
    # 8 whole blocks: the loop drops no remainder
    assert main(["synth", "-s", str(ini), "--out", str(iq), "--seconds", "0.256",
                 "--amplitude", "5", "--noise", "1"]) == 0
    assert iq.stat().st_size == 8 * 2 * BLOCK
    (tmp_path / "loop.u8").write_bytes(iq.read_bytes() * 2)
    assert main(["process-file", "-s", str(ini), "--iq", str(tmp_path / "loop.u8"),
                 "--out", str(tmp_path / "o"), "--block", str(BLOCK), "--device", "cpu"]) == 0
    offline = np.fromfile(tmp_path / "o" / "audio_VFO01.s16", np.int16)
    capsys.readouterr()
    n, per = 16, BLOCK // 128
    assert offline.size >= n * per
    sub = _Sub(zport)
    sub.collect(n)
    try:
        rc = _within(RUN_LIMIT, main, ["run", "-s", str(ini), "--iq", str(iq), "--fast",
                                       "--block", str(BLOCK), "--max-blocks", str(n),
                                       "--device", "cpu"])
        # the last frames may still be in flight: wait until they stop coming
        seen, deadline = -1, time.monotonic() + 10.0
        while len(sub.frames) != seen and len(sub.frames) < n and time.monotonic() < deadline:
            seen = len(sub.frames)
            time.sleep(0.5)
    finally:
        sub.close()
    assert rc == 0 and json.loads(capsys.readouterr().out)["blocks"] == n
    assert len(sub.frames) >= n // 2
    for f in sub.frames:
        assert len(f) == 3 and f[0] == b"VFO01" and struct.unpack("<I", f[1])[0] == 12000
        assert len(f[2]) == 2 * per
    stream = np.concatenate([np.frombuffer(f[2], np.int16) for f in sub.frames])
    # both feed the f32 entry: the same path, bit for bit
    np.testing.assert_array_equal(stream, offline[n * per - stream.size : n * per])


# --------------------------------------------------- local USB (stub)
USB_INI = """
sample_rate=1536000
center_frequency=1545600000
zmq_address=tcp://127.0.0.1:{port}
auto_start_tuner_serial=77777777
auto_start_biast=1
tuner_gain=240
[main_vfos]
size=1
1\\frequency=1545791000
1\\out_rate=384000
[vfos]
size=1
1\\frequency=1545791000
1\\gain=0.2
1\\data_rate=600
1\\topic=VFO01
"""


@pytest.fixture(scope="module")
def fake_lib(tmp_path_factory):
    so = tmp_path_factory.mktemp("fakertl") / "libfakertlsdr.so"
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
                    str(TESTS / "fake_librtlsdr.cpp"), "-o", str(so)],
                   check=True, capture_output=True)
    return str(so)


@pytest.fixture()
def rtl_env(fake_lib, monkeypatch):
    monkeypatch.setenv("SDRX_LIBRTLSDR", fake_lib)
    # the JAX binding caches its handle: drop it so the override applies
    monkeypatch.setattr(jrtlusb, "_LIB", None)
    monkeypatch.setattr(jrtlusb, "_LIB_PATH", None)
    return fake_lib


def _inspect(fake_lib):
    lib = ctypes.CDLL(fake_lib)
    for f in ("fake_get_sample_rate", "fake_get_center_freq", "fake_get_gain_mode",
              "fake_get_gain", "fake_get_agc_mode", "fake_get_bias_tee", "fake_get_open"):
        getattr(lib, f).restype = ctypes.c_int
        getattr(lib, f).argtypes = [ctypes.c_int]
    return lib


def test_usb_enumerate_and_serial_equal_jax(rtl_env):
    devs = rtlusb.enumerate_devices()
    assert [d.serial for d in devs] == ["00000001", "77777777"]
    assert [vars(d) for d in devs] == [vars(d) for d in jrtlusb.enumerate_devices()]
    assert rtlusb.index_by_serial("77777777") == 1
    assert rtlusb.index_by_serial("nope") == -1


def test_usb_stream_configure_and_tone(rtl_env):
    insp = _inspect(rtl_env)
    fs = 1_536_000
    with rtlusb.RtlUsbDevice(0) as dev:
        assert insp.fake_get_open(0) == 1
        assert dev.supported_gains()[-1] == 496
        dev.start(fs, 1_545_600_000, 2 * fs // 4, gain_tenths_db=496)
        # StartRtl parity: manual gain mode, exact gain, AGC off
        assert [insp.fake_get_sample_rate(0), insp.fake_get_center_freq(0),
                insp.fake_get_gain_mode(0), insp.fake_get_gain(0),
                insp.fake_get_agc_mode(0)] == [fs, 1_545_600_000, 1, 496, 0]
        blocks = [dev.ring.pop_f32(timeout_ms=5000) for _ in range(3)]
        assert all(b is not None for b in blocks)
        assert dev.set_center_freq(1_546_000_000) == 0  # sdrj.cpp:190-200
        assert insp.fake_get_center_freq(0) == 1_546_000_000
        dev.stop()
        assert not dev.active
    assert insp.fake_get_open(0) == 0
    x = np.concatenate(blocks)
    z = x[0::2] + 1j * x[1::2]
    assert abs(np.mean(z)) < 1.0
    spec = np.abs(np.fft.fft(z))
    assert np.argmax(spec) == len(z) // 8  # the stub's +fs/8 tone
    rest = spec.copy()
    rest[len(z) // 8] = 0
    assert spec.max() > 50 * rest.max()


def test_usb_ring_drops_when_consumer_stalls(rtl_env):
    with rtlusb.RtlUsbDevice(1) as dev:
        dev.start(1_536_000, 1_545_600_000, 768_000, gain_tenths_db=240, n_slots=2)
        deadline = time.monotonic() + 10.0
        while dev.dropped_blocks == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        n = dev.dropped_blocks
        assert dev.ring.stats["dropped"] >= n > 0


def test_usb_restart_recovers_streaming(rtl_env):
    insp = _inspect(rtl_env)
    with rtlusb.RtlUsbDevice(0) as dev:
        dev.start(1_536_000, 1_545_600_000, 768_000, gain_tenths_db=240)
        assert dev.ring.pop_raw(timeout_ms=5000) is not None
        old = dev.ring
        assert dev.restart() and dev.restarts == 1 and dev.active and dev.ring is not old
        assert insp.fake_get_sample_rate(0) == 1_536_000 and insp.fake_get_gain(0) == 240
        assert dev.ring.pop_raw(timeout_ms=5000) is not None
    assert insp.fake_get_open(0) == 0


def test_usb_bias_tee_standalone(rtl_env):
    insp = _inspect(rtl_env)
    assert rtlusb.bias_tee_standalone(True, device_idx=1)
    assert insp.fake_get_bias_tee(1) == 1 and insp.fake_get_open(1) == 0
    assert rtlusb.bias_tee_standalone(False, device_idx=1)
    assert insp.fake_get_bias_tee(1) == 0


def test_devices_output_equal_jax(rtl_env, capsys):
    assert main(["devices"]) == 0
    ours = capsys.readouterr().out
    assert jmain(["devices"]) == 0
    assert ours == capsys.readouterr().out
    assert [json.loads(line)["serial"] for line in ours.splitlines()] == ["00000001", "77777777"]


def test_run_local_usb_end_to_end(rtl_env, tmp_path, capsys):
    """``run`` on the stub: the device picked by serial, its bias tee set,
    the +fs/8 tone demodulated to 1 kHz audio, the device closed after."""
    zport = _free_port()
    ini = tmp_path / "usb.ini"
    ini.write_text(USB_INI.format(port=zport))
    sub = _Sub(zport)
    t = sub.collect(5)
    try:
        rc = _within(RUN_LIMIT, main, ["run", "-s", str(ini), "--block", str(BLOCK),
                                       "--max-blocks", "40", "--device", "cpu"])
        t.join(timeout=30)
    finally:
        sub.close()
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["blocks"] == 40 and summary["usb_restarts"] == 0
    assert len(sub.frames) == 5
    pcm = np.concatenate([np.frombuffer(f[2], np.int16) for f in sub.frames]).astype(np.float64)
    spec = np.abs(np.fft.rfft(pcm * np.hanning(len(pcm))))
    assert abs(np.argmax(spec) * 12000 / len(pcm) - 1000.0) < 30.0
    insp = _inspect(rtl_env)
    assert insp.fake_get_bias_tee(1) == 1 and insp.fake_get_gain(1) == 240
    assert insp.fake_get_open(1) == 0


def test_usb_unavailable_is_clean(monkeypatch, capsys, tmp_path):
    monkeypatch.setenv("SDRX_LIBRTLSDR", "/nonexistent/librtlsdr.so")
    assert not rtlusb.available()
    assert rtlusb.enumerate_devices() == [] and rtlusb.index_by_serial("x") == -1
    with pytest.raises(RuntimeError, match="librtlsdr not found"):
        rtlusb.RtlUsbDevice(0)
    assert main(["devices"]) == 2
    ini = tmp_path / "m.ini"
    ini.write_text(_mini(_free_port()))
    assert main(["run", "-s", str(ini), "--device", "cpu", "--max-blocks", "1"]) == 2
    assert "no source" in capsys.readouterr().err


# ---------------------------------------------------------------- bench
def test_bench_json_equal_jax(tmp_path, capsys):
    ini = tmp_path / "m.ini"
    ini.write_text(_mini(_free_port()))
    args = ["bench", "-s", str(ini), "--block", str(BLOCK), "--blocks", "2"]
    assert main([*args, "--device", "cpu"]) == 0
    ours = json.loads(capsys.readouterr().out)
    assert jmain([*args, "--backend", "cpu"]) == 0
    ref = json.loads(capsys.readouterr().out)
    # the JAX keys, and whether CUDA graphs ran (never on the CPU)
    assert set(ours) == set(ref) | {"cuda_graphs"} and ours["cuda_graphs"] is False
    assert ours["cost_model"] == ref["cost_model"]
    assert ours["mode"] == "kernels" and ours["device"] == "cpu"
    assert ours["block_samples"] == BLOCK and ours["msamples_per_second"] > 0
    assert main([*args, "--device", "cpu", "--plain"]) == 0
    assert json.loads(capsys.readouterr().out)["mode"] == "plain"


@pytest.mark.parametrize("command", ["run", "bench"])
@pytest.mark.parametrize(
    "extra", [["--mesh", "2x1"], ["--coordinator", "127.0.0.1:{port}"], ["--partition", "global"],
              ["--device", "cuda"]],
    ids=["mesh", "coordinator", "partition_global", "cuda_without_card"],
)
def test_unported_options_and_missing_card_exit_1(tmp_path, capsys, command, extra):
    """The dist/ options on ``run`` (over ``--iq --fast``) and ``bench``: a
    2x1 mesh of CPU devices (``bench`` reports ``"mode": "sharded"``), a
    coordinator with a process group of one, ``--partition global`` in one
    process; each exits 0.  ``--device cuda`` without a card exits 1
    (decided inside the test: with a card present there is nothing to show
    for it)."""
    if extra[-1] == "cuda" and torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    ini = tmp_path / "m.ini"
    ini.write_text(_mini(_free_port()))
    dev = [] if "--device" in extra else ["--device", "cpu"]
    extra = [e.format(port=_free_port()) for e in extra]
    if command == "run":
        raw = _u8_stream(1)
        (tmp_path / "r.u8").write_bytes(raw.tobytes())
        src = ["--iq", str(tmp_path / "r.u8"), "--fast", "--max-blocks", "1"]
    else:
        src = ["--blocks", "1"]
    capsys.readouterr()
    rc = main([command, "-s", str(ini), "--block", str(BLOCK), *src, *dev, *extra])
    out, err = capsys.readouterr()
    if extra[-1] == "cuda":
        assert rc == 1 and "CUDA is not available" in err
        return
    assert rc == 0, err
    summary = json.loads(out.strip().splitlines()[-1])
    assert summary["device"] == "cpu"
    if command == "bench":
        assert summary["mode"] == ("sharded" if "--mesh" in extra else "kernels")
    else:
        assert summary["blocks"] == 1
    if "--coordinator" in extra:
        assert summary["multihost"]["num_processes"] == 1
        assert summary["multihost"]["local_topics"] == ["VFO01"]


@pytest.mark.parametrize("flag", ["--num-processes", "--process-id"])
def test_multihost_flags_are_not_accepted(tmp_path, capsys, monkeypatch, flag):
    """The JAX CLI's multi-host flags: the port's parser takes them and they
    reach ``multihost.initialize`` with ``--coordinator`` (stubbed here to a
    process group of one)."""
    from sdrreceiver_tpu_torch.dist import multihost

    seen = []

    def fake(coordinator=None, num_processes=None, process_id=None):
        seen.append((coordinator, num_processes, process_id))
        return 0, 1

    monkeypatch.setattr(multihost, "initialize", fake)
    ini = tmp_path / "m.ini"
    ini.write_text(_mini(_free_port()))
    (tmp_path / "r.u8").write_bytes(_u8_stream(1).tobytes())
    assert main(["run", "-s", str(ini), "--device", "cpu", "--iq", str(tmp_path / "r.u8"),
                 "--fast", "--block", str(BLOCK), "--max-blocks", "1",
                 "--coordinator", "h:1", flag, "1"]) == 0
    want = ("h:1", 1, None) if flag == "--num-processes" else ("h:1", None, 1)
    assert seen == [want]
    assert json.loads(capsys.readouterr().out)["multihost"]["process_id"] == 0
