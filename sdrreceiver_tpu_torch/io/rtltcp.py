"""rtl_tcp client: network ingest of raw u8 IQ from a remote dongle server.

Port of ``sdrreceiver_tpu.io.rtltcp`` (numpy only).  Protocol as spoken by
the reference (sdrj.cpp:31-74,125-188):

  * on connect the server sends a 12-byte greeting: magic ``RTL0``, then
    big-endian u32 tuner type and u32 gain count (sdrj.cpp:139-144)
  * client commands are 5 bytes: u8 command id + big-endian u32 value
    (sdrj.cpp:168-188)
  * command ids (sdrj.h:10-16):
      0x01 SET_FREQ          0x02 SET_SAMPLE_RATE   0x03 SET_TUNER_GAIN_MODE
      0x04 SET_GAIN          0x05 SET_FREQ_COR      0x08 SET_AGC_MODE
      0x0d SET_TUNER_GAIN_INDEX
  * the startup sequence the reference sends (sdrj.cpp:56-65): AGC off,
    gain mode manual, gain index, sample rate, frequency
  * stream: raw interleaved u8 I,Q forever
"""

from __future__ import annotations

import socket
import struct
import time
from dataclasses import dataclass
from typing import Iterator

import numpy as np

__all__ = ["RtlTcpClient", "ElasticRtlTcp", "Greeting", "CMD"]


class CMD:
    SET_FREQ = 0x01
    SET_SAMPLE_RATE = 0x02
    SET_TUNER_GAIN_MODE = 0x03
    SET_GAIN = 0x04
    SET_FREQ_COR = 0x05
    SET_AGC_MODE = 0x08
    SET_TUNER_GAIN_INDEX = 0x0D


@dataclass(frozen=True)
class Greeting:
    tuner_type: int
    tuner_gain_count: int


class RtlTcpClient:
    """Blocking rtl_tcp ingest client (host side; feeds the pipeline)."""

    def __init__(self, address: str, timeout: float = 5.0):
        """``address`` is ``host:port`` (the ini ``remote_rtl`` format)."""
        host, _, port_s = address.partition(":")
        if not port_s:
            raise ValueError(f"remote_rtl address needs host:port, got {address!r}")
        self._sock = socket.create_connection((host, int(port_s)), timeout=timeout)
        self._sock.settimeout(timeout)
        self.greeting = self._read_greeting()

    def _read_greeting(self) -> Greeting:
        hdr = self._recv_exact(12)
        if hdr[:4] != b"RTL0":
            raise IOError(f"not an rtl_tcp server (magic {bytes(hdr[:4])!r})")
        tuner_type, gain_count = struct.unpack(">II", hdr[4:12])
        return Greeting(tuner_type, gain_count)

    def _recv_exact(self, count: int) -> bytearray:
        buf = bytearray(count)
        view = memoryview(buf)
        got = 0
        while got < count:
            n = self._sock.recv_into(view[got:], count - got)
            if not n:
                raise IOError("rtl_tcp connection closed")
            got += n
        return buf

    def send_command(self, cmd: int, value: int) -> None:
        """5-byte packet: cmd + big-endian u32 (sdrj.cpp:168-188)."""
        self._sock.sendall(struct.pack(">BI", cmd, value & 0xFFFFFFFF))

    def configure(
        self, sample_rate: int, frequency: int, gain_index: int = 0, agc: bool = False
    ) -> None:
        """The reference's startup command sequence, same order
        (sdrj.cpp:56-65)."""
        self.send_command(CMD.SET_AGC_MODE, 1 if agc else 0)
        self.send_command(CMD.SET_TUNER_GAIN_MODE, 1)
        self.send_command(CMD.SET_TUNER_GAIN_INDEX, gain_index)
        self.send_command(CMD.SET_SAMPLE_RATE, sample_rate)
        self.send_command(CMD.SET_FREQ, frequency)

    def set_center_freq(self, frequency: int) -> None:
        self.send_command(CMD.SET_FREQ, frequency)

    def read_block(self, n_bytes: int) -> np.ndarray:
        """Read exactly ``n_bytes`` of u8 IQ (the reference reads
        ``(samplerate/4)*2`` per block, sdrj.cpp:43-45,149-153) into a
        fresh writable array."""
        return np.frombuffer(self._recv_exact(n_bytes), dtype=np.uint8)

    def iter_blocks(self, n_bytes: int) -> Iterator[np.ndarray]:
        while True:
            yield self.read_block(n_bytes)

    def close(self) -> None:
        """Shut the socket down (waking a reader blocked in ``recv`` on
        another thread) and close it."""
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()


class ElasticRtlTcp:
    """Self-healing rtl_tcp client: reconnect with exponential backoff.

    The reference keeps its process alive on stream loss but requires a
    manual restart (sdrj.cpp:107-123); a long-running service needs the
    stream to come back by itself.  On any stream error this wrapper closes,
    reconnects with capped exponential backoff, replays the configure
    sequence (and the most recent retune), and resumes yielding blocks of
    exactly ``n_bytes``: the partial bytes of a dropped block are discarded
    (as the reference drops whole ring buffers, jonti/sdr.cpp:104-111), so
    frame alignment downstream never breaks.

    The FIRST connect fails loudly (a wrong address is a configuration
    error, not an outage).  ``stats`` counts reconnects and failed connect
    attempts for run summaries.  After :meth:`close` a reader gets an error
    instead of a reconnect.
    """

    def __init__(
        self,
        address: str,
        timeout: float = 5.0,
        initial_backoff: float = 0.5,
        max_backoff: float = 8.0,
        max_retries: int | None = None,
        sleep=time.sleep,
    ):
        self.address = address
        self.timeout = timeout
        self.initial_backoff = float(initial_backoff)
        self.max_backoff = float(max_backoff)
        self.max_retries = max_retries
        self._sleep = sleep
        self._config: tuple[int, int, int, bool] | None = None
        self._freq: int | None = None
        self.stats = {"reconnects": 0, "connect_failures": 0}
        self._closed = False
        self._client = RtlTcpClient(address, timeout)  # loud on first failure

    @property
    def greeting(self) -> Greeting:
        return self._client.greeting

    @property
    def closed(self) -> bool:
        """True once :meth:`close` was called."""
        return self._closed

    def configure(
        self, sample_rate: int, frequency: int, gain_index: int = 0, agc: bool = False
    ) -> None:
        self._config = (sample_rate, frequency, gain_index, agc)
        self._client.configure(sample_rate, frequency, gain_index, agc)

    def set_center_freq(self, frequency: int) -> None:
        """Retune; remembered so a reconnect replays it.  A send failure is
        swallowed: the reconnect path re-applies the frequency."""
        self._freq = int(frequency)
        try:
            self._client.set_center_freq(frequency)
        except OSError:
            pass

    def _reconnect(self) -> None:
        self.stats["reconnects"] += 1
        self._client.close()
        backoff = self.initial_backoff
        attempt = 0
        while True:
            if self._closed:
                raise IOError("rtl_tcp client closed")
            try:
                self._client = RtlTcpClient(self.address, self.timeout)
                if self._config is not None:
                    self._client.configure(*self._config)
                if self._freq is not None:
                    self._client.set_center_freq(self._freq)
                return
            except OSError:
                self.stats["connect_failures"] += 1
                attempt += 1
                if self.max_retries is not None and attempt > self.max_retries:
                    raise
                self._sleep(backoff)
                backoff = min(backoff * 2.0, self.max_backoff)

    def read_block(self, n_bytes: int) -> np.ndarray:
        while True:
            try:
                return self._client.read_block(n_bytes)
            except OSError:
                if self._closed:
                    raise  # deliberate shutdown, not an outage
                self._reconnect()

    def iter_blocks(self, n_bytes: int) -> Iterator[np.ndarray]:
        while True:
            yield self.read_block(n_bytes)

    def close(self) -> None:
        self._closed = True
        self._client.close()
