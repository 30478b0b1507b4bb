"""Build and load the native ingest library (``ringbuffer.cpp``) with ctypes.

g++ compiles the source at first use into ``build/`` at the repository root
(git-ignored, beside the CUDA kernels' library), under a name made from a
hash of the source and flags, so a changed source builds anew.  A failed
build raises with the compiler's output; only :func:`available` turns it
into a plain "no", the answer ``run`` checks before choosing the ring.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import subprocess
import time

import numpy as np

from ...obs import trace

__all__ = ["IngestRing", "available", "load_library", "u8_to_f32"]

_SRC = pathlib.Path(__file__).with_name("ringbuffer.cpp")
_BUILD = pathlib.Path(__file__).resolve().parents[3] / "build"
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_U8P = ctypes.POINTER(ctypes.c_uint8)
_F32P = ctypes.POINTER(ctypes.c_float)


@functools.cache
def load_library() -> ctypes.CDLL:
    """The native library, built on first use; raises ``RuntimeError`` if
    g++ is missing or fails."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    h.update(_SRC.read_bytes())
    so = _BUILD / f"ringbuffer_{h.hexdigest()[:16]}.so"
    if not so.exists():
        _BUILD.mkdir(exist_ok=True)
        tmp = _BUILD / f"{so.stem}.{os.getpid()}.tmp.so"
        try:
            proc = subprocess.run(
                ["g++", *_FLAGS, str(_SRC), "-o", str(tmp)],
                capture_output=True, text=True, check=False,
            )
        except OSError as e:
            raise RuntimeError(f"native ingest library: g++ not runnable ({e})") from e
        if proc.returncode:
            raise RuntimeError(f"native ingest library: g++ failed:\n{proc.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.rb_create.restype = ctypes.c_void_p
    lib.rb_create.argtypes = [ctypes.c_int, ctypes.c_int64]
    lib.rb_destroy.restype = None
    lib.rb_destroy.argtypes = [ctypes.c_void_p]
    lib.rb_push.restype = ctypes.c_int
    lib.rb_push.argtypes = [ctypes.c_void_p, _U8P, ctypes.c_int64, ctypes.c_int]
    lib.rb_pop_f32.restype = ctypes.c_int64
    lib.rb_pop_f32.argtypes = [ctypes.c_void_p, _F32P, ctypes.c_int64, ctypes.c_int]
    lib.rb_pop_raw.restype = ctypes.c_int64
    lib.rb_pop_raw.argtypes = [ctypes.c_void_p, _U8P, ctypes.c_int64, ctypes.c_int]
    lib.rb_close.restype = None
    lib.rb_close.argtypes = [ctypes.c_void_p]
    for f in ("rb_stat_pushed", "rb_stat_popped", "rb_stat_dropped"):
        getattr(lib, f).restype = ctypes.c_uint64
        getattr(lib, f).argtypes = [ctypes.c_void_p]
    for f in ("rb_stat_depth", "rb_stat_high_water"):
        getattr(lib, f).restype = ctypes.c_int
        getattr(lib, f).argtypes = [ctypes.c_void_p]
    lib.rb_last_push_ns.restype = ctypes.c_int64
    lib.rb_last_push_ns.argtypes = [ctypes.c_void_p]
    lib.u8_to_f32.restype = None
    lib.u8_to_f32.argtypes = [_U8P, _F32P, ctypes.c_int64]
    return lib


def available() -> bool:
    """True when the native library builds and loads here."""
    try:
        load_library()
    except (RuntimeError, OSError):
        return False
    return True


def u8_to_f32(raw: np.ndarray) -> np.ndarray:
    """Native u8 -> float32 LUT conversion ((v - 127), jonti/sdr.cpp:43-49)."""
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    out = np.empty(raw.size, dtype=np.float32)
    load_library().u8_to_f32(raw.ctypes.data_as(_U8P), out.ctypes.data_as(_F32P), raw.size)
    return out


class IngestRing:
    """Python handle over the native SPSC block ring: one producer thread
    pushes whole u8 blocks (dropping a block when every slot is full, like
    jonti/sdr.cpp:104-111), one consumer pops them.  The reference sizes its
    ring at 20 slots (jonti/sdr.h:89); same default.

    ``last_push_ns`` is the push time (``time.monotonic_ns()``'s clock) of
    the block the last pop returned.  While tracing is on, each pop records
    the span ``ring.queue`` (push to pop) and the counter
    ``ring.high_water``."""

    def __init__(self, block_bytes: int, n_slots: int = 20):
        self._lib = load_library()
        self._h = self._lib.rb_create(n_slots, block_bytes)
        if not self._h:
            raise ValueError(f"rb_create({n_slots}, {block_bytes}) refused")
        self.block_bytes = block_bytes
        self.n_slots = n_slots
        self.last_push_ns = 0

    def push(self, data: np.ndarray, block_on_full: bool = False) -> int:
        """0 = stored, 1 = dropped (ring full), -1 = closed."""
        data = np.ascontiguousarray(data, dtype=np.uint8)
        return self._lib.rb_push(self._h, data.ctypes.data_as(_U8P), data.size,
                                 1 if block_on_full else 0)

    def pop_f32(self, timeout_ms: int = -1) -> np.ndarray | None:
        """The next block converted to float32, or None on timeout or when
        the ring is closed and drained."""
        out = np.empty(self.block_bytes, dtype=np.float32)
        n = self._lib.rb_pop_f32(self._h, out.ctypes.data_as(_F32P), out.size, timeout_ms)
        if n > 0:
            self._popped()
        return out[:n] if n > 0 else None

    def pop_raw(self, timeout_ms: int = -1) -> np.ndarray | None:
        """The next block as a fresh u8 array (never reused by the ring), or
        None on timeout or when the ring is closed and drained."""
        out = np.empty(self.block_bytes, dtype=np.uint8)
        n = self._lib.rb_pop_raw(self._h, out.ctypes.data_as(_U8P), out.size, timeout_ms)
        if n > 0:
            self._popped()
        return out[:n] if n > 0 else None

    def _popped(self) -> None:
        self.last_push_ns = self._lib.rb_last_push_ns(self._h)
        tr = trace.current()
        if tr is not None:
            tr.span("ring.queue", self.last_push_ns, time.monotonic_ns(), child=False)
            tr.count("ring.high_water", self._lib.rb_stat_high_water(self._h))

    def depth(self) -> int:
        """The blocks waiting in the ring now: one native call, cheap
        enough to ask before every pop."""
        return self._lib.rb_stat_depth(self._h)

    def close(self) -> None:
        """Wake a waiting consumer; pops drain what is left, then None."""
        if self._h:
            self._lib.rb_close(self._h)

    @property
    def stats(self) -> dict:
        return {
            "pushed": self._lib.rb_stat_pushed(self._h),
            "popped": self._lib.rb_stat_popped(self._h),
            "dropped": self._lib.rb_stat_dropped(self._h),
            "depth": self._lib.rb_stat_depth(self._h),
            "high_water": self._lib.rb_stat_high_water(self._h),
        }

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.rb_close(h)
            self._lib.rb_destroy(h)
