"""Spectrum observability: the reference GUI's scope, as arrays.

Port of ``sdrreceiver_tpu.obs.spectrum`` (``power_spectrum`` and
``SpectrumEMA``; the live, switchable scope comes with the ``run`` entry).
The reference's scope (mainwindow.cpp:411-478) is an 8192-point
Hann-windowed complex FFT of the selected tap, power in dB with a 0.95/0.05
EMA, a floor at 0 dB, fftshift to center DC and a 5-bin moving average; the
same math here, on ``torch.fft``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["NFFT_DEFAULT", "power_spectrum", "SpectrumEMA"]

NFFT_DEFAULT = 8192


def power_spectrum(x, nfft: int = NFFT_DEFAULT) -> torch.Tensor:
    """One un-smoothed spectrum frame in the reference's units, f32 ``[nfft]``
    on ``x``'s device.

    Takes the first ``nfft`` samples of ``x`` (zero-padded if short), Hann
    window (mainwindow.cpp:284-288), |FFT|, then
    ``10*log10(max(1e5 * |X| / nfft, 1))`` (mainwindow.cpp:439-441), and
    fftshift so index 0 is the lowest frequency (mainwindow.cpp:429-437).
    ``x`` is planar ``[2, T]`` f32 (the tap format), complex ``[T]`` or real
    ``[T]``, as a tensor or a numpy array."""
    x = torch.as_tensor(x)
    if x.dim() == 2 and x.shape[0] == 2:
        re, im = x[0], x[1]
    elif x.is_complex():
        re, im = x.real, x.imag
    else:
        re, im = x, torch.zeros_like(x)
    re, im = re.to(torch.float32), im.to(torch.float32)
    n = re.shape[-1]
    if n < nfft:
        re = torch.nn.functional.pad(re, (0, nfft - n))
        im = torch.nn.functional.pad(im, (0, nfft - n))
    z = torch.complex(re[:nfft], im[:nfft])
    k = torch.arange(nfft, dtype=torch.float32, device=z.device)
    w = 0.5 * (1.0 - torch.cos(2.0 * np.pi * k / (nfft - 1.0)))
    mag = torch.fft.fft(z * w).abs()
    db = 10.0 * torch.log10(torch.clamp(1e5 * mag / nfft, min=1.0))
    return torch.fft.fftshift(db)


class SpectrumEMA:
    """EMA'd spectrum of one tap (host side).  ``update`` every N blocks
    (the reference strides 5, sdrj.cpp:296-303) and read ``smoothed`` for
    the 5-bin averaged curve the GUI plots (mainwindow.cpp:450-454)."""

    def __init__(self, nfft: int = NFFT_DEFAULT, alpha: float = 0.05):
        self.nfft = nfft
        self.alpha = alpha
        self.pwr = np.zeros(nfft, dtype=np.float64)

    def update(self, block) -> np.ndarray:
        frame = power_spectrum(block, self.nfft).cpu().numpy()
        self.pwr = self.pwr * (1.0 - self.alpha) + self.alpha * frame
        return self.pwr

    @property
    def smoothed(self) -> np.ndarray:
        p = self.pwr
        n = len(p) - 10
        return (p[0:n] + p[1 : 1 + n] + p[2 : 2 + n] + p[3 : 3 + n] + p[4 : 4 + n]) / 5.0
