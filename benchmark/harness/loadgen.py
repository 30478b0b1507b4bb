"""The live cell's load generator, a process of its own: a loopback rtl_tcp
server that plays the recording at the dongle's rate, and a ZMQ subscriber
that takes every topic.  It imports neither torch nor the program.

    python3 benchmark/harness/loadgen.py    (driven by livecell.py)

Protocol on stdin / stdout:
  in   one JSON line (chunk, rate_bytes, n_bytes, pool_bytes, zmq_port,
       topics, delay_s, wait_frames), then the recording's ``pool_bytes``
       bytes
  out  {"port": P}, the server's port, once it listens and the subscriber
       has connected
  ...  the program connects, sends its 5 start-up commands; after
       ``delay_s`` the server sends the stream in chunks of ``chunk``
       bytes, chunk k once the dongle would have filled it (``(k + 1)
       chunk / rate_bytes`` s after the start), until ``n_bytes``
  out  once the program has left and every topic has ``wait_frames``
       frames (or a minute has passed): {"due_ns", "sent_ns", "commands",
       "frames": {topic: [[recv_ns, rate, n_bytes, parts, topic_ok], ...]}}
  in   {"frames": {topic: [frame index, ...]}}
  out  {"payloads": {topic: {index: base64 int16}}}
Times are ``time.monotonic_ns()``, one clock for every process.
"""

from __future__ import annotations

import base64
import json
import os
import socket
import struct
import sys
import threading
import time


class Subscriber:
    def __init__(self, port: int, topics: list[str]):
        import zmq

        self.ctx = zmq.Context()
        self.sock = self.ctx.socket(zmq.SUB)
        self.sock.setsockopt(zmq.RCVHWM, 0)
        self.sock.setsockopt(zmq.RECONNECT_IVL, 10)
        self.sock.connect(f"tcp://127.0.0.1:{port}")
        for t in topics:
            self.sock.setsockopt(zmq.SUBSCRIBE, t.encode())
        self.frames: list[tuple[int, list[bytes]]] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._go, daemon=True)
        self._thread.start()

    def _go(self) -> None:
        while not self._stop.is_set():
            if self.sock.poll(20):
                parts = self.sock.recv_multipart()
                self.frames.append((time.monotonic_ns(), parts))

    def counts(self, topics: list[str]) -> dict[str, int]:
        seen = [parts[0] for _, parts in list(self.frames)]
        return {t: seen.count(t.encode().ljust(5, b"\0")[:5]) for t in topics}

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=10)
        self.sock.close(linger=0)
        self.ctx.term()


def serve(hdr: dict, data: bytes, srv: socket.socket, out) -> None:
    conn, _ = srv.accept()
    commands: list[list[int]] = []

    def read_commands():
        buf = b""
        try:
            while chunk := conn.recv(4096):
                buf += chunk
                while len(buf) >= 5:
                    commands.append([buf[0], struct.unpack(">I", buf[1:5])[0]])
                    buf = buf[5:]
        except OSError:
            pass

    with conn:
        conn.sendall(b"RTL0" + struct.pack(">II", 5, 29))
        reader = threading.Thread(target=read_commands, daemon=True)
        reader.start()
        end = time.monotonic() + 60
        while len(commands) < 5 and time.monotonic() < end:
            time.sleep(0.01)
        time.sleep(hdr["delay_s"])
        chunk, n_bytes = hdr["chunk"], hdr["n_bytes"]
        period_ns = chunk * 1e9 / hdr["rate_bytes"]
        due, sent = [], []
        t0 = time.monotonic_ns()
        try:
            for k in range(-(-n_bytes // chunk)):
                at = t0 + round((k + 1) * period_ns)
                wait = (at - time.monotonic_ns()) / 1e9
                if wait > 0:
                    time.sleep(wait)
                lo = k * chunk % len(data)
                piece = data[lo:lo + chunk]
                if len(piece) < chunk:  # the recording's cycle wraps inside the chunk
                    piece += data[:chunk - len(piece)]
                conn.sendall(piece)
                due.append(at)
                sent.append(time.monotonic_ns())
        except OSError:
            pass  # the program left early
        reader.join(timeout=120)  # until the program closes its connection
    out.update(due_ns=due, sent_ns=sent, commands=commands)


def main() -> int:
    # the server's thread must not wait for the subscriber's to let go of
    # the interpreter: a chunk sent late is charged to the system
    sys.setswitchinterval(1e-4)
    # off the core the program's process keeps for itself, if there are others
    others = set(range(os.cpu_count() or 1)) - os.sched_getaffinity(0)
    if others:
        os.sched_setaffinity(0, others)
    stdin, stdout = sys.stdin.buffer, sys.stdout
    hdr = json.loads(stdin.readline())
    data = stdin.read(hdr["pool_bytes"])
    sub = Subscriber(hdr["zmq_port"], hdr["topics"])
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    srv.settimeout(300)
    print(json.dumps({"port": srv.getsockname()[1]}), file=stdout, flush=True)
    result: dict = {}
    try:
        serve(hdr, data, srv, result)
    finally:
        srv.close()
    # frames still in flight: wait for each topic's ``wait_frames``, up to
    # a minute past the stream's end, and half a second for the rest
    end = time.monotonic() + 60
    while time.monotonic() < end and not all(
            n >= hdr["wait_frames"] for n in sub.counts(hdr["topics"]).values()):
        time.sleep(0.05)
    time.sleep(0.5)
    sub.close()
    frames: dict[str, list] = {t: [] for t in hdr["topics"]}
    payloads: dict[str, list[bytes]] = {t: [] for t in hdr["topics"]}
    for t_ns, parts in sub.frames:
        topic = parts[0].decode("ascii", "replace").rstrip("\x00")
        if topic not in frames:
            continue
        rate = struct.unpack("<I", parts[1])[0] if len(parts) > 1 and len(parts[1]) == 4 else -1
        n = len(parts[2]) if len(parts) > 2 else -1
        frames[topic].append([t_ns, rate, n, len(parts), len(parts[0]) == 5])
        payloads[topic].append(parts[2] if len(parts) > 2 else b"")
    result["frames"] = frames
    print(json.dumps(result), file=stdout, flush=True)
    want = json.loads(stdin.readline())["frames"]
    print(json.dumps({"payloads": {
        t: {str(i): base64.b64encode(payloads[t][i]).decode() for i in idx
            if i < len(payloads[t])}
        for t, idx in want.items()}}), file=stdout, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
