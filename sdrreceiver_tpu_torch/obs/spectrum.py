"""Spectrum observability: the reference GUI's scope, as arrays.

Port of ``sdrreceiver_tpu.obs.spectrum``: ``power_spectrum``,
``SpectrumEMA`` and the live, switchable ``LiveScope`` of ``run --scope``.
The reference's scope (mainwindow.cpp:411-478) is an 8192-point
Hann-windowed complex FFT of the selected tap, power in dB with a 0.95/0.05
EMA, a floor at 0 dB, fftshift to center DC and a 5-bin moving average; the
same math here, on ``torch.fft``.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

__all__ = ["NFFT_DEFAULT", "power_spectrum", "SpectrumEMA", "LiveScope"]

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


class LiveScope:
    """Runtime-switchable scope over a compiled receiver's taps.

    The reference switches which VFO feeds its GUI FFT while streaming
    (combo box -> ``fftVFOSlot`` topic compare, mainwindow.cpp:539-566,
    vfo.cpp:492-509) and can turn the FFT off (mainwindow.cpp:616-626).
    Here every tap is compiled into the step, and which one is copied to
    the host each block is this object's runtime choice: :meth:`wants` is
    the ``run_pipeline`` fetch filter, so inactive taps never leave the
    device.  The reference refreshes its FFT every 5th buffer
    (sdrj.cpp:296-303), so :meth:`wants` also says no on the blocks whose
    frame would be discarded.

    :meth:`observe` runs on the pipeline thread with host (numpy) outputs,
    so the FFT runs on the CPU; :meth:`set_scope`, :meth:`set_fft` and
    :meth:`snapshot` are called from the control thread.  One lock guards
    the shared fields.
    """

    def __init__(self, tap_rates: dict[str, int], initial: str | None = "main", stride: int = 5):
        self.tap_rates = dict(tap_rates)
        self.active = initial if initial in self.tap_rates else None
        self.enabled = True
        self.stride = max(1, int(stride))
        self.ema = SpectrumEMA()
        self._count = 0
        self._lock = threading.Lock()

    # ---- pipeline side ----
    def wants(self, key: str) -> bool:
        """Fetch filter: every non-tap output; the active tap only on the
        blocks whose frame the EMA consumes (every ``stride``-th)."""
        if not key.startswith("tap/"):
            return True
        with self._lock:
            return (
                self.enabled
                and self.active is not None
                and key == f"tap/{self.active}"
                and self._count % self.stride == 0
            )

    def observe(self, outputs: dict) -> None:
        """Feed one step's host outputs.  Counts every block (fetched or
        not) so the cadence matches :meth:`wants`; the first frame after a
        switch updates at once."""
        with self._lock:
            active, enabled, ema = self.active, self.enabled, self.ema
            if not enabled or active is None:
                return
            consume = self._count % self.stride == 0
            self._count += 1
        v = outputs.get(f"tap/{active}")
        if consume and v is not None:
            # the EMA captured under the lock: a concurrent set_scope swaps
            # in a fresh one, which a stale frame must not reach
            ema.update(v)

    # ---- control side ----
    def set_scope(self, name) -> dict:
        name = str(name)
        if name in ("off", "none", ""):
            with self._lock:
                self.active = None
            return {"ok": True, "scope": None}
        if name not in self.tap_rates:
            return {"error": f"unknown tap {name!r}", "valid": sorted(self.tap_rates)}
        with self._lock:
            if name != self.active:
                self.active = name
                self.ema = SpectrumEMA()  # new signal, new statistics
                self._count = 0  # the next frame updates at once
        return {"ok": True, "scope": name, "rate": self.tap_rates[name]}

    def set_fft(self, on) -> dict:
        with self._lock:
            self.enabled = bool(int(on))
        return {"ok": True, "fft": int(self.enabled)}

    def snapshot(self, bins=512) -> dict:
        """The smoothed curve box-averaged down to ``bins`` points (a UDP
        reply stays one datagram)."""
        with self._lock:
            active = self.active
            curve = self.ema.smoothed
        bins = max(16, min(int(bins), len(curve)))
        # trim the remainder symmetrically so the band stays centred
        extra = len(curve) % bins
        lo = extra // 2
        folded = curve[lo : lo + len(curve) - extra].reshape(bins, -1).mean(axis=1)
        return {
            "ok": True,
            "scope": active,
            "rate": self.tap_rates.get(active),
            "bins": bins,
            "db": [round(float(v), 2) for v in folded],
        }
