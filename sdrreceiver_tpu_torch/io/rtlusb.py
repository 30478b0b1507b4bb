"""Local RTL-SDR USB ingest via a ctypes binding over librtlsdr.

Port of ``sdrreceiver_tpu.io.rtlusb`` (numpy and ctypes only).  The
counterpart of the reference's device runtime: device enumeration with
serials (jonti/sdr.cpp:248-273, sdrj.cpp:306-311), StartRtl-style configure
plus an async reader thread feeding a drop-on-full ring
(jonti/sdr.cpp:73-184), two-phase shutdown (jonti/sdr.cpp:187-243), runtime
retune (sdrj.cpp:190-200), and the bias-tee open-set-close dance when no
device is running (sdrj.cpp:202-238).

The shared library is ``$SDRX_LIBRTLSDR`` when set (the tests point it at an
ABI-compatible stub, ``tests/fake_librtlsdr.cpp``), else the usual sonames.
Without it :func:`available` is False and the rest of the receiver (rtl_tcp,
file ingest) is unaffected.  The USB callback thread touches only numpy and
the native ring, never a tensor.
"""

from __future__ import annotations

import ctypes
import functools
import os
import threading
from dataclasses import dataclass

import numpy as np

from . import native

__all__ = [
    "DeviceInfo", "RtlUsbDevice", "available", "bias_tee_standalone",
    "enumerate_devices", "index_by_serial", "load_library",
]

_SONAMES = ("librtlsdr.so.2", "librtlsdr.so.0", "librtlsdr.so")

_READ_CB = ctypes.CFUNCTYPE(
    None, ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint32, ctypes.c_void_p
)


@functools.cache
def _open(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    p, u32, i = ctypes.c_void_p, ctypes.c_uint32, ctypes.c_int
    lib.rtlsdr_get_device_count.restype = u32
    lib.rtlsdr_get_device_count.argtypes = []
    lib.rtlsdr_get_device_name.restype = ctypes.c_char_p
    lib.rtlsdr_get_device_name.argtypes = [u32]
    lib.rtlsdr_get_device_usb_strings.restype = i
    lib.rtlsdr_get_device_usb_strings.argtypes = [u32] + [ctypes.c_char_p] * 3
    lib.rtlsdr_open.restype = i
    lib.rtlsdr_open.argtypes = [ctypes.POINTER(p), u32]
    lib.rtlsdr_close.restype = i
    lib.rtlsdr_close.argtypes = [p]
    for name in ("rtlsdr_set_sample_rate", "rtlsdr_set_center_freq"):
        getattr(lib, name).restype = i
        getattr(lib, name).argtypes = [p, u32]
    for name in ("rtlsdr_set_tuner_gain_mode", "rtlsdr_set_tuner_gain",
                 "rtlsdr_set_agc_mode", "rtlsdr_set_bias_tee"):
        getattr(lib, name).restype = i
        getattr(lib, name).argtypes = [p, i]
    lib.rtlsdr_get_tuner_gains.restype = i
    lib.rtlsdr_get_tuner_gains.argtypes = [p, ctypes.POINTER(i)]
    lib.rtlsdr_reset_buffer.restype = i
    lib.rtlsdr_reset_buffer.argtypes = [p]
    lib.rtlsdr_read_async.restype = i
    lib.rtlsdr_read_async.argtypes = [p, _READ_CB, ctypes.c_void_p, u32, u32]
    lib.rtlsdr_cancel_async.restype = i
    lib.rtlsdr_cancel_async.argtypes = [p]
    return lib


def load_library() -> ctypes.CDLL | None:
    """librtlsdr (or the ``$SDRX_LIBRTLSDR`` override), or None if absent."""
    override = os.environ.get("SDRX_LIBRTLSDR", "")
    for cand in [override] if override else _SONAMES:
        try:
            return _open(cand)
        except OSError:
            continue
    return None


def available() -> bool:
    return load_library() is not None


@dataclass(frozen=True)
class DeviceInfo:
    index: int
    name: str
    manufacturer: str
    product: str
    serial: str


def enumerate_devices() -> list[DeviceInfo]:
    """All attached devices with their USB strings (jonti/sdr.cpp:248-273)."""
    lib = load_library()
    if lib is None:
        return []
    out = []
    for i in range(int(lib.rtlsdr_get_device_count())):
        name = lib.rtlsdr_get_device_name(i) or b""
        manu, prod, serial = (ctypes.create_string_buffer(256) for _ in range(3))
        lib.rtlsdr_get_device_usb_strings(i, manu, prod, serial)
        out.append(DeviceInfo(
            index=i,
            name=name.decode(errors="replace"),
            manufacturer=manu.value.decode(errors="replace"),
            product=prod.value.decode(errors="replace"),
            serial=serial.value.decode(errors="replace"),
        ))
    return out


def index_by_serial(serial: str) -> int:
    """First device index whose serial matches, else -1 (sdrj.cpp:306-311)."""
    for dev in enumerate_devices():
        if dev.serial == serial:
            return dev.index
    return -1


class RtlUsbDevice:
    """One open RTL2832U device driving the native ingest ring.

    Lifecycle as in the reference: open (sdr::OpenRtl), :meth:`start`
    (sdr::StartRtl: manual gain mode with the ini's tenths-of-dB gain, AGC
    off, reset_buffer, then rtlsdr_read_async on a worker thread whose
    callback pushes each u8 block into the 20-slot ring, dropping it when
    the ring is full), :meth:`stop` (cancel_async, join, drain;
    jonti/sdr.cpp:187-243), :meth:`close`.
    """

    def __init__(self, index: int = 0):
        lib = load_library()
        if lib is None:
            raise RuntimeError("librtlsdr not found (set SDRX_LIBRTLSDR or install rtl-sdr)")
        self._lib = lib
        self.index = index
        self._dev = ctypes.c_void_p()
        res = lib.rtlsdr_open(ctypes.byref(self._dev), index)
        if res != 0:
            raise RuntimeError(f"rtlsdr_open({index}) failed: {res}")
        self.ring: native.IngestRing | None = None
        self._thread: threading.Thread | None = None
        self._cb_ref = None  # keeps the CFUNCTYPE object alive
        self.active = False
        self.dropped_blocks = 0
        self.restarts = 0
        self._params: tuple | None = None

    # -- configuration ----------------------------------------------------
    def set_center_freq(self, frequency: int) -> int:
        return self._lib.rtlsdr_set_center_freq(self._dev, int(frequency))

    def set_bias_tee(self, on: bool) -> int:
        return self._lib.rtlsdr_set_bias_tee(self._dev, 1 if on else 0)

    def supported_gains(self) -> list[int]:
        n = self._lib.rtlsdr_get_tuner_gains(self._dev, None)
        if n <= 0:
            return []
        buf = (ctypes.c_int * n)()
        self._lib.rtlsdr_get_tuner_gains(self._dev, buf)
        return list(buf)

    # -- streaming ---------------------------------------------------------
    def start(
        self,
        sample_rate: int,
        frequency: int,
        buflen_bytes: int,
        gain_tenths_db: int,
        n_slots: int = 20,
    ) -> None:
        if self.active:
            raise RuntimeError("already streaming")
        self._params = (int(sample_rate), int(frequency), int(buflen_bytes),
                        int(gain_tenths_db), int(n_slots))
        lib = self._lib
        lib.rtlsdr_reset_buffer(self._dev)
        lib.rtlsdr_set_sample_rate(self._dev, int(sample_rate))
        lib.rtlsdr_set_center_freq(self._dev, int(frequency))
        lib.rtlsdr_set_tuner_gain_mode(self._dev, 1)
        lib.rtlsdr_set_tuner_gain(self._dev, int(gain_tenths_db))
        lib.rtlsdr_set_agc_mode(self._dev, 0)
        ring = native.IngestRing(block_bytes=int(buflen_bytes), n_slots=n_slots)
        self.ring = ring

        def _callback(buf, length, _ctx):
            # USB callback thread -> ring slot; a full ring drops the whole
            # buffer, exactly like jonti/sdr.cpp:104-111
            arr = ctypes.cast(buf, ctypes.POINTER(ctypes.c_uint8 * length)).contents
            if ring.push(np.frombuffer(arr, dtype=np.uint8)) == 1:
                self.dropped_blocks += 1

        self._cb_ref = _READ_CB(_callback)

        def _reader():
            lib.rtlsdr_read_async(self._dev, self._cb_ref, None, 0, int(buflen_bytes))
            ring.close()

        self._thread = threading.Thread(target=_reader, name="rtlsdr_read_async", daemon=True)
        self._thread.start()
        self.active = True

    def stop(self) -> None:
        """Two-phase shutdown: cancel the async read, join, drain."""
        if not self.active:
            return
        self._lib.rtlsdr_cancel_async(self._dev)
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        if self.ring is not None:
            self.ring.close()
        self.active = False

    def restart(self) -> bool:
        """Recovery after a stalled or lost stream: stop, close the
        (possibly dead) handle, re-open the same index and start again with
        the last :meth:`start` parameters, into a NEW ring (readers re-read
        ``self.ring``).  The reference needs a manual restart
        (sdrj.cpp:107-123); ``run`` calls this when the ring goes silent.
        True when streaming again."""
        if self._params is None:
            return False
        self.stop()
        if self._dev:
            self._lib.rtlsdr_close(self._dev)
            self._dev = ctypes.c_void_p()
        if self._lib.rtlsdr_open(ctypes.byref(self._dev), self.index) != 0:
            return False
        self.start(*self._params)
        self.restarts += 1
        return True

    def close(self) -> None:
        self.stop()
        if self._dev:
            self._lib.rtlsdr_close(self._dev)
            self._dev = ctypes.c_void_p()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def bias_tee_standalone(on: bool, device_idx: int = 0) -> bool:
    """Bias tee when no device is running: open, set, close (the
    reference's dance at sdrj.cpp:202-238)."""
    lib = load_library()
    if lib is None:
        return False
    dev = ctypes.c_void_p()
    if lib.rtlsdr_open(ctypes.byref(dev), device_idx) != 0:
        return False
    try:
        return lib.rtlsdr_set_bias_tee(dev, 1 if on else 0) == 0
    finally:
        lib.rtlsdr_close(dev)
