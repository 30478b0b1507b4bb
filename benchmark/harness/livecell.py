"""Open loop at the dongle's rate through the program's ``run`` command.

A child process (``loadgen.py``) serves the seeded recording as a loopback
rtl_tcp server, in chunks of ``traffic["chunk_bytes"]`` sent when the
dongle would have filled them, and subscribes to every topic on ZMQ; the
load thus never waits for the system under test.  ``run`` runs in this
process (the rtl_tcp reader, the ingest ring, ``run_pipeline``, the egress
hub) for ``warmup_blocks`` blocks (the first captures the CUDA graph), the
window's ``seconds * fs / block`` blocks, and one more, whose arrival
publishes the window's last.  A frame's latency is the time the subscriber
received it less the time the last byte of its block was due from the
dongle.  Frames of a topic arrive in block order, the first of them for
the stream's first block.  A traced run profiles ``trace_blocks`` blocks
in the middle of the window on the card (``trace.Slice``) and reads the
host's spans from the window's other blocks.
"""

from __future__ import annotations

import base64
import contextlib
import json
import math
import pathlib
import socket
import statistics
import subprocess
import sys
import tempfile

import numpy as np
import torch

from . import check, gen, program
from .trace import DeviceTrace, Slice, TraceData

__all__ = ["run"]

LOADGEN = pathlib.Path(__file__).with_name("loadgen.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class LoadGen:
    """The child process ``loadgen.py`` and its protocol on its pipes."""

    def __init__(self, hdr: dict, pool: np.ndarray):
        self.proc = subprocess.Popen([sys.executable, str(LOADGEN)], stdin=subprocess.PIPE,
                                     stdout=subprocess.PIPE)
        self.proc.stdin.write((json.dumps(hdr) + "\n").encode())
        self.proc.stdin.write(pool.tobytes())
        self.proc.stdin.flush()
        self.port = self.recv()["port"]

    def recv(self) -> dict:
        return json.loads(self.proc.stdout.readline())

    def payloads(self, frames: dict) -> dict:
        self.proc.stdin.write((json.dumps({"frames": frames}) + "\n").encode())
        self.proc.stdin.flush()
        return self.recv()["payloads"]

    def __enter__(self) -> "LoadGen":
        return self

    def __exit__(self, *exc) -> None:
        try:
            self.proc.wait(timeout=60 if exc[0] is None else 0.1)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        finally:
            self.proc.stdin.close()
            self.proc.stdout.close()


def run(cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, fault=None) -> dict:
    """One run; ``fault(rx)`` (tests only) breaks each receiver ``run`` builds."""
    from reference.receiver import Reference, plan

    block = int(traffic["block"])
    fs = int(cfg["sample_rate"])
    n_pool = max(1, math.ceil(traffic["pool_seconds"] * fs / block))
    pool = gen.recording(cfg, block, n_pool, seed, device)
    chains = plan(cfg)[2]
    topics = [c.topic for c in chains]
    warm = int(traffic["warmup_blocks"])
    n_win = max(1, round(seconds * fs / block))
    n_blocks = warm + n_win + 1
    chunk = int(traffic["chunk_bytes"])
    zport = _free_port()
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        if trace:
            DeviceTrace.warm()
    n_trace = min(int(traffic["trace_blocks"]), n_win)
    part = Slice(n_trace, first=warm + (n_win - n_trace) // 2, profile=cuda) if trace else None
    spans = program.Spans(before={"runtime.upload": part.before_upload}) if trace else None
    hdr = {"chunk": chunk, "rate_bytes": 2 * fs, "n_bytes": n_blocks * 2 * block,
           "pool_bytes": pool.nbytes, "zmq_port": zport, "topics": topics,
           "delay_s": float(traffic["delay_s"]), "wait_frames": warm + n_win}
    with LoadGen(hdr, pool) as loadgen:
        program.prebuild()
        with tempfile.TemporaryDirectory() as d, program.on_receiver(fault):
            ini = pathlib.Path(d) / "live.ini"
            ini.write_text(program.ini_text(cfg, f"tcp://127.0.0.1:{zport}",
                                            f"127.0.0.1:{loadgen.port}"))
            with spans or contextlib.nullcontext():
                rc, summary = program.run_command(
                    ["run", "-s", ini, "--device", device, "--block", block,
                     "--max-blocks", n_blocks])
        if part is not None:
            part.close()
        if rc != 0:
            raise RuntimeError(f"the program's run exited {rc}")
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        res = loadgen.recv()

        def due(b: int) -> int:  # when block b's last byte was due
            return res["due_ns"][((b + 1) * 2 * block - 1) // chunk]

        win = range(warm, warm + n_win)
        frames = res["frames"]
        t_end = max((f[0] for fl in frames.values() for f in fl), default=due(win[-1]))
        lat, missing, malformed = [], 0, 0
        for c in chains:
            got = frames[c.topic]
            for b in win:
                if b >= len(got):
                    missing += 1
                    lat.append((t_end - due(b)) / 1e6)
                    continue
                t_ns, rate, n, parts, topic_ok = got[b]
                malformed += not (parts == 3 and topic_ok and rate == c.out_rate
                                  and n == 2 * (block // c.decimation))
                lat.append((t_ns - due(b)) / 1e6)
        rng = np.random.default_rng([seed, 17])
        sample = sorted(int(b) for b in rng.choice(list(win), min(int(traffic["check_blocks"]),
                                                                   n_win), replace=False))
        payloads = loadgen.payloads({t: sample for t in topics})

    lost = summary.get("ring", {}).get("dropped", 0) + summary.get("rtl_tcp", {}).get(
        "reconnects", 0)
    attempted = len(topics) * n_win
    p50, p95 = np.percentile(lat, [50, 95])
    out = {
        "attempted": attempted,
        "failed": min(attempted, missing + malformed + lost * len(topics)),
        "e2e": {"latency_p50_ms": float(p50), "latency_p95_ms": float(p95),
                "setup_s": (due(warm - 1) / 1e9) - t_start},
        "memory_peak_bytes": peak,
        "late_ms": np.percentile([(s - d) / 1e6 for s, d in zip(res["sent_ns"], res["due_ns"])],
                                 [50, 100]).tolist(),
    }
    if trace:
        t = TraceData("live", cfg, traffic, block, steps=part.steps)
        rec = zip(spans.calls["runtime.record_block"], spans.args["runtime.record_block"])
        for (at, _), sec in list(rec)[warm:warm + n_win]:
            (t.block_seconds if part.outside(at) else t.block_seconds_profiled).append(sec)
        t.spans = {k: [d for s, d in v[warm:warm + n_win] if part.outside(s)]
                   for k, v in spans.calls.items()}
        if part.trace is not None:
            part.trace.reduce(t, spans.calls)
        out["trace"] = t
        out["host_ms_per_block"] = {k: statistics.median(v) * 1e3 if v else None for k, v in
                                    (("unprofiled", t.block_seconds),
                                     ("profiled", t.block_seconds_profiled))}

    tally = check.Tally()
    tally.malformed = malformed
    ref = Reference(cfg, pool, device)
    for b in sample:
        got = {}
        for topic in topics:
            s = payloads.get(topic, {}).get(str(b))
            if s is not None:
                got[topic] = np.frombuffer(base64.b64decode(s), np.int16)
        tally.missing += len(got) < len(topics)
        want = ref.audio(b)
        tally.compare(got, {k: v for k, v in want.items() if k in got})
    out["numbers"] = tally.numbers()
    return out
