"""IQ recording files and test-signal synthesis (numpy only).

Port of ``sdrreceiver_tpu.io.iqfile``: the offline file path the reference
declared but never implemented (``sdrj::process_file``, sdrj.h:28).  Formats:

  u8   interleaved unsigned-8-bit I,Q: the raw RTL dongle / rtl_tcp wire
       format (value semantics: (v - 127), jonti/sdr.cpp:43-49)
  cf32 interleaved float32 I,Q (little-endian)
"""

from __future__ import annotations

import pathlib
from typing import Iterator

import numpy as np

__all__ = ["read_iq", "write_iq", "iter_blocks", "synthesize_channels", "to_u8"]


def read_iq(path: str | pathlib.Path, fmt: str = "u8") -> np.ndarray:
    """Read a whole IQ recording into ``complex64 [T]``."""
    p = pathlib.Path(path)
    if fmt == "u8":
        raw = np.fromfile(p, dtype=np.uint8)
        raw = raw[: len(raw) // 2 * 2].astype(np.float32) - np.float32(127.0)
    elif fmt == "cf32":
        raw = np.fromfile(p, dtype="<f4")
        raw = raw[: len(raw) // 2 * 2]
    else:
        raise ValueError(f"unknown IQ format {fmt!r} (use 'u8' or 'cf32')")
    pairs = raw.reshape(-1, 2)
    return (pairs[:, 0] + 1j * pairs[:, 1]).astype(np.complex64)


def to_u8(iq: np.ndarray) -> np.ndarray:
    """``complex [T]`` -> interleaved ``uint8 [2T]`` as an RTL dongle would
    deliver it (rounded, clipped to 0..255 around the 127 offset)."""
    inter = np.empty(2 * len(iq), dtype=np.float32)
    inter[0::2] = np.real(iq)
    inter[1::2] = np.imag(iq)
    return np.clip(np.round(inter + 127.0), 0, 255).astype(np.uint8)


def write_iq(path: str | pathlib.Path, iq: np.ndarray, fmt: str = "u8") -> None:
    """Write ``complex [T]`` as an IQ recording."""
    if fmt == "u8":
        to_u8(iq).tofile(path)
    elif fmt == "cf32":
        inter = np.empty(2 * len(iq), dtype="<f4")
        inter[0::2] = np.real(iq)
        inter[1::2] = np.imag(iq)
        inter.tofile(path)
    else:
        raise ValueError(f"unknown IQ format {fmt!r}")


def iter_blocks(
    iq: np.ndarray, block: int, pad_final: bool = False
) -> Iterator[np.ndarray]:
    """Yield fixed-size blocks; the final partial block is zero-padded when
    ``pad_final`` else dropped."""
    n_full = len(iq) // block
    for i in range(n_full):
        yield iq[i * block : (i + 1) * block]
    rem = len(iq) - n_full * block
    if rem and pad_final:
        tail = np.zeros(block, dtype=iq.dtype)
        tail[:rem] = iq[n_full * block :]
        yield tail


def synthesize_channels(
    t_len: int,
    fs: int,
    center: int,
    channels: list[tuple[int, float, float]],
    noise: float = 0.0,
    dc_offset: complex = 0.0,
    seed: int = 0,
) -> np.ndarray:
    """USB tones at RF channel frequencies, ``complex64 [t_len]``.

    ``channels`` is a list of (rf_hz, audio_tone_hz, amplitude): each places a
    carrier so that USB demodulation of the channel yields ``audio_tone_hz``.
    """
    n = np.arange(t_len)
    x = np.zeros(t_len, dtype=np.complex128)
    for rf, tone, amp in channels:
        x += amp * np.exp(2j * np.pi * ((rf - center) + tone) * n / fs)
    if noise > 0:
        rng = np.random.default_rng(seed)
        x += noise * (rng.standard_normal(t_len) + 1j * rng.standard_normal(t_len))
    x += dc_offset
    return x.astype(np.complex64)
