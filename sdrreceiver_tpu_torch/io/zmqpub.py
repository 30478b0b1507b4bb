"""ZeroMQ egress, wire-compatible with the reference for JAERO interop.

Port of ``sdrreceiver_tpu.io.zmqpub`` (numpy only; pyzmq optional).

Message format (zmqpublisher.cpp:82-96): a 3-part ZMQ message
  frame 0: topic, ALWAYS 5 bytes (the reference hard-codes length 5 —
           zmqpublisher.cpp:91 — so JAERO subscribes on 5-byte prefixes)
  frame 1: little-endian uint32 output sample rate
  frame 2: raw payload (int16 LE audio, or compressed-IQ bytes)

Socket topology matches vfo.cpp:160-174: ONE bound PUB socket shared by every
demodulated channel (the reference's static ``bind_publisher``), plus optional
per-main-VFO connect-mode sockets for forwarding compressed IQ.  TCP
keepalive/reconnect options per zmqpublisher.cpp:24-37.
"""

from __future__ import annotations

import struct
import time

import numpy as np

from ..obs import trace

try:
    import zmq

    _HAVE_ZMQ = True
except ImportError:  # pragma: no cover - pyzmq is optional
    zmq = None
    _HAVE_ZMQ = False

__all__ = ["Publisher", "EgressHub", "pack_frames"]


def pack_frames(topic: str, sample_rate: int, payload: bytes) -> list[bytes]:
    """Build the 3 wire frames.  Topic is truncated/padded to exactly 5
    bytes, reproducing zmq_send(topic, 5) semantics (zmqpublisher.cpp:91):
    the reference reads 5 bytes from the C string regardless of its length."""
    t = topic.encode("utf-8")[:5].ljust(5, b"\x00")
    return [t, struct.pack("<I", sample_rate), payload]


class Publisher:
    """One PUB socket, bind or connect mode."""

    def __init__(self, address: str, bind: bool, context: "zmq.Context | None" = None):
        if not _HAVE_ZMQ:
            raise RuntimeError("pyzmq not available")
        self.address = address
        self.bind = bind
        self._ctx = context or zmq.Context.instance()
        self._sock = self._ctx.socket(zmq.PUB)
        # keepalive + reconnect settings per zmqpublisher.cpp:24-37
        self._sock.setsockopt(zmq.TCP_KEEPALIVE, 1)
        self._sock.setsockopt(zmq.TCP_KEEPALIVE_CNT, 10)
        self._sock.setsockopt(zmq.TCP_KEEPALIVE_IDLE, 1)
        self._sock.setsockopt(zmq.TCP_KEEPALIVE_INTVL, 1)
        self._sock.setsockopt(zmq.RECONNECT_IVL, 1000)
        self._sock.setsockopt(zmq.RECONNECT_IVL_MAX, 0)
        if bind:
            # unlike the reference (which pops a dialog and carries on with a
            # dead socket, zmqpublisher.cpp:46-56), a bind failure raises
            self._sock.bind(address)
        else:
            self._sock.connect(address)

    def publish(self, topic: str, sample_rate: int, payload: bytes | np.ndarray) -> None:
        if isinstance(payload, np.ndarray):
            payload = payload.tobytes()
        if len(payload) == 0:  # reference skips empty payloads
            return
        self._sock.send_multipart(pack_frames(topic, sample_rate, payload))

    def close(self) -> None:
        self._sock.close(linger=0)


class EgressHub:
    """Routes CompiledReceiver outputs to the right sockets.

    ``audio/*`` outputs go to the shared bound socket at the global
    ``zmq_address``; ``iq/<topic>`` outputs go to that main VFO's connect-mode
    socket (mainwindow.cpp:109-126, vfo.cpp:426-453).
    """

    def __init__(self, plan, context=None):
        self.plan = plan
        self.rates: dict[str, int] = {}
        self._route: dict[str, Publisher] = {}
        self._bound: Publisher | None = None
        ctx = context
        if plan.zmq_address and any(b.subs for g in plan.groups for b in g.buckets):
            self._bound = Publisher(plan.zmq_address, bind=True, context=ctx)
        for g in plan.groups:
            for b in g.buckets:
                for s in b.subs:
                    if self._bound is not None:
                        self._route[f"audio/{s.topic}"] = self._bound
                        self.rates[f"audio/{s.topic}"] = b.out_rate
            if g.publishes_iq:
                pub = Publisher(g.zmq_address, bind=False, context=ctx)
                self._route[f"iq/{g.zmq_topic}"] = pub
                self.rates[f"iq/{g.zmq_topic}"] = g.out_rate

    def publish_outputs(self, outputs: dict[str, np.ndarray]) -> int:
        """Send one step's outputs; returns messages sent (traced as
        ``egress.publish``)."""
        tr = trace.current()
        t0 = time.monotonic_ns() if tr is not None else 0
        sent = 0
        for key, arr in outputs.items():
            pub = self._route.get(key)
            if pub is None:
                continue
            topic = key.split("/", 1)[1]
            pub.publish(topic, self.rates[key], np.asarray(arr))
            sent += 1
        if tr is not None:
            tr.span("egress.publish", t0, time.monotonic_ns())
        return sent

    def close(self) -> None:
        seen = set()
        for pub in self._route.values():
            if id(pub) not in seen:
                pub.close()
                seen.add(id(pub))

