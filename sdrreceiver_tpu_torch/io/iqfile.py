"""Test-signal synthesis and the u8 dongle quantization (numpy only).

Ports of ``sdrreceiver_tpu.io.iqfile.synthesize_channels`` and of the u8
rounding in its ``write_iq``, so a script on a machine without the JAX
package can make the same signals.
"""

from __future__ import annotations

import numpy as np

__all__ = ["synthesize_channels", "to_u8"]


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


def to_u8(iq: np.ndarray) -> np.ndarray:
    """``complex [T]`` -> interleaved ``uint8 [2T]`` as an RTL dongle would
    deliver it (rounded, clipped to 0..255 around the 127 offset)."""
    inter = np.empty(2 * len(iq), dtype=np.float32)
    inter[0::2] = np.real(iq)
    inter[1::2] = np.imag(iq)
    return np.clip(np.round(inter + 127.0), 0, 255).astype(np.uint8)
