"""Filter taps of the receiver chain, designed from the configuration's numbers.

A frozen copy of the formulas the receiver's taps follow (SDRReceiver's
gnuradio-derived designers), kept here so the benchmark's reference builds
its taps itself:

  low_pass   windowed-sinc with a Hamming window; tap count
             ``int(53 * fs / (22 * transition))`` forced odd; window and taps
             rounded to float32, the DC gain normalised by a sequential
             float64 sum over the float32 taps (gnuradio/firfilter.cpp:64-119)
  hilbert    125-tap Hilbert transformer, normalised by its L2 norm
             (jonti/dsp.cpp:202-216)
  HALF_BAND  the 11-tap half-band table (halfbanddecimator.h)

Every array is float32 in convolution order: ``y[n] = sum_k c[k] x[n - k]``.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["low_pass", "hilbert", "HALF_BAND", "HILBERT_DELAY"]

HILBERT_LEN = 125
#: The USB demodulator delays the I arm by the Hilbert filter's group delay.
HILBERT_DELAY = (HILBERT_LEN - 1) // 2

_HB_SIDE = [0.0060431029837374152, 0.0, -0.049372515458761493, 0.0, 0.29332944952052842]
HALF_BAND = np.array(_HB_SIDE + [0.5] + _HB_SIDE[::-1], dtype=np.float32)


def low_pass(gain: float, fs: float, cutoff: float, transition: float) -> np.ndarray:
    """Hamming-windowed sinc low-pass with DC gain ``gain``."""
    ntaps = int(53.0 * fs / (22.0 * transition))
    if ntaps % 2 == 0:
        ntaps += 1
    m = (ntaps - 1) // 2
    k = np.arange(ntaps, dtype=np.float64)
    win = (0.54 - 0.46 * np.cos(2.0 * np.pi * k / (ntaps - 1))).astype(np.float32)
    n = np.arange(-m, m + 1, dtype=np.float64)
    w0 = 2.0 * np.pi * cutoff / fs
    taps = np.full(ntaps, w0 / np.pi)
    nz = n != 0
    taps[nz] = np.sin(n[nz] * w0) / (n[nz] * np.pi)
    taps = (taps * win).astype(np.float32)
    total = float(taps[m])
    for v in taps[m + 1:]:
        total += 2.0 * float(v)
    return (taps.astype(np.float64) * (gain / total)).astype(np.float32)


def hilbert(length: int = HILBERT_LEN) -> np.ndarray:
    """Hilbert transformer taps, ``c[n] = (1 / (pi k)) (1 - cos(pi k))`` with
    ``k = n - L/2`` (0 at the centre), rounded to float32 and normalised."""
    k = np.arange(length, dtype=np.float64) - length // 2
    c = np.zeros(length)
    nz = k != 0
    c[nz] = (1.0 / (np.pi * k[nz])) * (1.0 - np.cos(np.pi * k[nz]))
    c = c.astype(np.float32)
    norm = math.sqrt(float(np.sum(c.astype(np.float64) ** 2)))
    return (c / np.float32(norm)).astype(np.float32)
