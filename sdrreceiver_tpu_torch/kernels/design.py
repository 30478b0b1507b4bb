"""Filter design: windowed-sinc low-pass, window functions, Hilbert, half-band.

Numpy-only port of ``sdrreceiver_tpu.kernels.design`` (same formulas, same
float64/float32 rounding points; tests pin the arrays bit-equal):
  * windowed-sinc low-pass + windows: gnuradio/firfilter.cpp:64-119,174-253
    (gnuradio firdes math)
  * Hilbert transformer: jonti/dsp.cpp:202-216
  * half-band coefficient value tables: halfbanddecimator.h:28-98
    (numeric filter data, embedded verbatim so channel outputs match the
    reference chain bit-for-bit at the filter level)

All designers return float32 numpy arrays in "c" order, i.e. the causal
convolution sense  y[n] = sum_k c[k] * x[n-k].  The reference stores taps
reversed into its circular-buffer FIR (jonti/dsp.cpp:59-71 reads oldest->newest
against points[0..N-1]); both conventions coincide for the symmetric filters
used everywhere, and the Hilbert designer below already accounts for it.

Design happens on the host at plan-compile time with float64 math, so none of
this is in the hot path.
"""

from __future__ import annotations

import enum
import math

import numpy as np

__all__ = [
    "Window",
    "window",
    "max_attenuation",
    "compute_ntaps",
    "low_pass",
    "hilbert",
    "HILBERT_LEN",
    "HILBERT_DELAY",
    "half_band",
    "HALF_BAND_TAP_COUNTS",
]


class Window(enum.Enum):
    """Window types (reference enum: gnuradio/firfilter.h:10-22)."""

    HAMMING = "hamming"
    HANN = "hann"
    BLACKMAN = "blackman"
    RECTANGULAR = "rectangular"
    KAISER = "kaiser"
    BLACKMAN_HARRIS = "blackman_harris"
    BARTLETT = "bartlett"
    FLATTOP = "flattop"


#: Stopband attenuation in dB used for tap-count estimation
#: (reference: gnuradio/firfilter.cpp:141-171).
_MAX_ATTEN = {
    Window.HAMMING: 53.0,
    Window.HANN: 44.0,
    Window.BLACKMAN: 74.0,
    Window.RECTANGULAR: 21.0,
    Window.BLACKMAN_HARRIS: 92.0,
    Window.BARTLETT: 27.0,
    Window.FLATTOP: 93.0,
}


def max_attenuation(win: Window, beta: float = 0.0) -> float:
    if win is Window.KAISER:
        return beta / 0.1102 + 8.7
    try:
        return _MAX_ATTEN[win]
    except KeyError:
        raise ValueError(f"unknown window type {win!r}") from None


def _coswindow(ntaps: int, coeffs: tuple[float, ...]) -> np.ndarray:
    """Generalized cosine window: sum_k (-1)^k c_k cos(2 pi k n / (N-1))."""
    m = float(ntaps - 1)
    n = np.arange(ntaps, dtype=np.float64)
    out = np.zeros(ntaps, dtype=np.float64)
    for k, c in enumerate(coeffs):
        out += ((-1.0) ** k) * c * np.cos(2.0 * np.pi * k * n / m)
    return out


def window(win: Window, ntaps: int) -> np.ndarray:
    """Build a window (reference formulas: gnuradio/firfilter.cpp:190-253).

    Only the types the reference's build() accepts are supported here
    (HAMMING/HANN/BLACKMAN/BLACKMAN_HARRIS); same restriction as
    gnuradio/firfilter.cpp:174-188.
    """
    if win is Window.HAMMING:
        return _coswindow(ntaps, (0.54, 0.46))
    if win is Window.HANN:
        return _coswindow(ntaps, (0.5, 0.5))
    if win is Window.BLACKMAN:
        return _coswindow(ntaps, (0.42, 0.5, 0.08))
    if win is Window.BLACKMAN_HARRIS:
        # 92 dB variant (the reference's default attenuation table entry).
        return _coswindow(ntaps, (0.35875, 0.48829, 0.14128, 0.01168))
    raise ValueError(f"window type {win!r} not buildable")


def compute_ntaps(
    sampling_freq: float,
    transition_width: float,
    win: Window = Window.HAMMING,
    beta: float = 0.0,
) -> int:
    """Tap-count rule: ntaps = atten * Fs / (22 * transition), forced odd
    (reference: gnuradio/firfilter.cpp:108-119)."""
    a = max_attenuation(win, beta)
    ntaps = int(a * sampling_freq / (22.0 * transition_width))
    if ntaps % 2 == 0:
        ntaps += 1
    return ntaps


def low_pass(
    gain: float,
    sampling_freq: float,
    cutoff_freq: float,
    transition_width: float,
    win: Window = Window.HAMMING,
    beta: float = 0.0,
) -> np.ndarray:
    """Windowed-sinc low-pass design (formulas: gnuradio/firfilter.cpp:64-106).

    taps[n+M] = sin(n*w0)/(n*pi) * w[n+M]  (w0 = 2 pi fc / Fs), normalized so
    the DC gain equals ``gain``.  Returns float32 taps of odd length.
    """
    if sampling_freq <= 0.0:
        raise ValueError("sampling_freq must be > 0")
    if cutoff_freq <= 0.0 or cutoff_freq > sampling_freq / 2:
        raise ValueError("need 0 < cutoff_freq <= sampling_freq / 2")
    if transition_width <= 0:
        raise ValueError("transition_width must be > 0")

    ntaps = compute_ntaps(sampling_freq, transition_width, win, beta)
    m = (ntaps - 1) // 2
    w = window(win, ntaps).astype(np.float32)  # reference windows are float32

    n = np.arange(-m, m + 1, dtype=np.float64)
    fw_t0 = 2.0 * np.pi * cutoff_freq / sampling_freq
    taps = np.empty(ntaps, dtype=np.float64)
    nz = n != 0
    taps[nz] = np.sin(n[nz] * fw_t0) / (n[nz] * np.pi)
    taps[~nz] = fw_t0 / np.pi
    taps = (taps * w).astype(np.float32)

    # Normalize DC gain to `gain` (reference: firfilter.cpp:93-103 sums center
    # tap + 2x one side, i.e. the full symmetric sum).  BIT-EXACT with the
    # compiled reference (tests/test_oracle.py): the sum must be a SEQUENTIAL
    # double accumulation over the float32 taps (numpy's pairwise sum rounds
    # differently for >128 taps), and the scale must stay in double until the
    # final per-tap rounding (firfilter.cpp:100-104 multiplies float*double).
    fmax = float(taps[m])
    for v in taps[m + 1 :]:
        fmax += 2.0 * float(v)
    return (taps.astype(np.float64) * (gain / fmax)).astype(np.float32)


#: The reference's USB chain constants (vfo.cpp:136-137): a 125-tap Hilbert
#: transformer paired with a (125-1)/2 = 62-sample delay on the I arm.
HILBERT_LEN = 125
HILBERT_DELAY = (HILBERT_LEN - 1) // 2


def hilbert(length: int = HILBERT_LEN) -> np.ndarray:
    """Hilbert transformer taps (formula: jonti/dsp.cpp:202-216).

    c[n] = Fs/(pi (n-L/2)) * (1 - cos(pi (n-L/2))), c[L/2] = 0, normalized by
    sqrt(sum c^2).  The Fs factor cancels in the normalization, so it is
    omitted.  Returned in convolution order: the reference stores the reversed
    array into its FIR (dsp.cpp:214-216) whose inner loop re-reverses it
    (dsp.cpp:218-231), so its output is convolution with THIS array.
    """
    n = np.arange(length, dtype=np.float64) - length // 2
    c = np.zeros(length, dtype=np.float64)
    nz = n != 0
    # float32 intermediate like the reference's float tempCoeffs.
    c[nz] = (1.0 / (np.pi * n[nz])) * (1.0 - np.cos(np.pi * n[nz]))
    c = c.astype(np.float32)
    norm = math.sqrt(float(np.sum(c.astype(np.float64) ** 2)))
    return (c / np.float32(norm)).astype(np.float32)


#: Half-band decimator coefficient tables (filter data from
#: halfbanddecimator.h:28-98).  Keys are tap counts.  Each is
#: symmetric with zero odd taps (except the 0.5 center) — the defining
#: half-band structure.  The application always uses the 11-tap set
#: (vfo.cpp:130-132); 23/51 are constructor-supported alternates
#: (halfbanddecimator.cpp:10-34), 15/21 are latent tables.
_HB_TABLES: dict[int, np.ndarray] = {}


def _hb(side: list[float], center: float = 0.5) -> np.ndarray:
    """Build a symmetric half-band tap array from its leading half."""
    full = np.array(side + [center] + side[::-1], dtype=np.float32)
    return full


_HB_TABLES[11] = _hb([0.0060431029837374152, 0.0, -0.049372515458761493, 0.0, 0.29332944952052842])
_HB_TABLES[15] = _hb(
    [-0.001442203300285281, 0.0, 0.013017512802724852, 0.0, -0.061653278604903369, 0.0, 0.30007792316024057]
)
_HB_TABLES[23] = _hb(
    [
        -0.00014987651418332164,
        0.0,
        0.0014748633283609852,
        0.0,
        -0.0074416944990005314,
        0.0,
        0.026163522731980929,
        0.0,
        -0.077593699116544707,
        0.0,
        0.30754683719791986,
    ]
)
_HB_TABLES[21] = _hb(
    [
        0.0,
        0.003619160996209284,
        0.0,
        -0.012238250198266238,
        0.0,
        0.034315551069916406,
        0.0,
        -0.08582925310376682,
        0.0,
        0.31058306173328054,
    ],
    center=0.49909945900525354,
)
_HB_TABLES[51] = _hb(
    [
        0.0010175926971811044,
        0.0,
        -0.0013058886799502411,
        0.0,
        0.0020730260200910026,
        0.0,
        -0.0034255790572079265,
        0.0,
        0.005490505092950141,
        0.0,
        -0.008434405740804745,
        0.0,
        0.012502602797600649,
        0.0,
        -0.01810260996706492,
        0.0,
        0.026000146160530365,
        0.0,
        -0.037851497102093665,
        0.0,
        0.05801218485928863,
        0.0,
        -0.1025751653146947,
        0.0,
        0.31684426465520726,
    ],
    center=0.499509647157934,
)

HALF_BAND_TAP_COUNTS = tuple(sorted(_HB_TABLES))


def half_band(taps: int = 11) -> np.ndarray:
    """Return the half-band low-pass tap set with the given length."""
    try:
        return _HB_TABLES[taps].copy()
    except KeyError:
        raise ValueError(
            f"no half-band table with {taps} taps (have {HALF_BAND_TAP_COUNTS})"
        ) from None
