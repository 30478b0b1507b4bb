"""WAV (PCM16) audio file writing for demodulated channels.

Port of ``sdrreceiver_tpu.io.wavout`` (numpy only).  The reference
publishes raw int16 frames to JAERO over ZMQ; for offline ``process-file``
runs a listenable artifact is more useful than a bare .s16,
so each channel can also be written as a standard RIFF/WAVE file at its
channel rate (12/24/48 kHz).
"""

from __future__ import annotations

import pathlib
import struct

import numpy as np

__all__ = ["write_wav"]


def write_wav(path: str | pathlib.Path, pcm: np.ndarray, sample_rate: int) -> None:
    """Write mono int16 PCM to a .wav file."""
    pcm = np.ascontiguousarray(pcm, dtype="<i2")
    data = pcm.tobytes()
    hdr = b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE"
    hdr += b"fmt " + struct.pack(
        "<IHHIIHH",
        16,  # chunk size
        1,  # PCM
        1,  # mono
        sample_rate,
        sample_rate * 2,  # byte rate
        2,  # block align
        16,  # bits
    )
    hdr += b"data" + struct.pack("<I", len(data))
    pathlib.Path(path).write_bytes(hdr + data)
