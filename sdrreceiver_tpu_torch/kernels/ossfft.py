"""Overlap-save FFT fast convolution on ``torch.fft``.

Port of ``sdrreceiver_tpu.kernels.ossfft`` (the reference's vendored
kiss_fastfir, kiss_fft130/kiss_fastfir.c:106-202, as a batched block
operator).  A ``[C, T]`` block with its ``ntaps - 1`` carried history is
framed into overlapping ``nfft`` segments, convolved as one batched FFT ->
bin multiply -> inverse FFT, and the fully overlapped outputs kept.  The
streaming interface is :func:`kernels.fir.conv_block`'s, so the two are
interchangeable.  The JAX package computes this with ``jnp.fft`` outside any
Pallas kernel; here the FFTs are cuFFT (or the CPU FFT) through
``torch.fft``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["default_nfft", "oss_prepare", "oss_block"]


def default_nfft(ntaps: int) -> int:
    """Smallest power of two >= 4*ntaps (kiss_fastfir picks >= 2*ntaps,
    kiss_fft130/kiss_fastfir.c:60-67; 4x keeps the kept fraction high)."""
    nfft = 1
    while nfft < 4 * ntaps:
        nfft *= 2
    return nfft


def oss_prepare(
    taps,
    channels: int | None = None,
    nfft: int | None = None,
    device: torch.device | str = "cpu",
) -> dict:
    """Frequency-domain filter bank for :func:`oss_block`.

    ``taps`` is ``[ntaps]`` or ``[C, ntaps]`` in convolution order.  Returns
    ``{"H": [C, nfft] complex64, "Hr": [C, nfft//2+1] complex64, "ntaps",
    "nfft"}``; the spectra are computed in numpy exactly as the JAX
    package does and moved to ``device``."""
    t = np.asarray(taps, dtype=np.float32)
    if t.ndim == 1:
        t = t[None, :]
    if channels is not None and t.shape[0] == 1 and channels != 1:
        t = np.broadcast_to(t, (channels, t.shape[1])).copy()
    ntaps = t.shape[1]
    if nfft is None:
        nfft = default_nfft(ntaps)
    if nfft < 2 * ntaps:
        raise ValueError(f"nfft {nfft} < 2*ntaps {2 * ntaps}")
    hpad = np.zeros((t.shape[0], nfft), dtype=np.float32)
    hpad[:, :ntaps] = t
    return {
        "H": torch.tensor(np.fft.fft(hpad, axis=-1).astype(np.complex64), device=device),
        # half-spectrum bank for real inputs (rfft/irfft: half the work)
        "Hr": torch.tensor(np.fft.rfft(hpad, axis=-1).astype(np.complex64), device=device),
        "ntaps": ntaps,
        "nfft": nfft,
    }


def _frame(xfull: torch.Tensor, ntaps: int, nfft: int):
    """``[C, ntaps-1+T]`` -> overlapping segments ``[C, nseg, nfft]`` (a
    view over the zero-padded stream), plus ``t_out``, ``hop``, ``nseg``.
    The pad makes the last segment end exactly at the padded length."""
    t_out = xfull.shape[-1] - (ntaps - 1)
    hop = nfft - ntaps + 1
    nseg = -(-t_out // hop)  # ceil
    pad = (ntaps - 1) + nseg * hop - xfull.shape[-1]
    xp = torch.nn.functional.pad(xfull, (0, pad))
    return xp.unfold(-1, nfft, hop), t_out, hop, nseg


def oss_block(
    hist: torch.Tensor, x: torch.Tensor, filt: dict, stride: int = 1
) -> tuple[torch.Tensor, torch.Tensor]:
    """Streaming overlap-save step, a drop-in for ``fir.conv_block``:
    ``hist [C, ntaps-1]`` (the input's dtype), ``x [C, T]`` real or
    complex, returns ``(new_hist, y [C, T // stride])``.  Real inputs run
    rfft/irfft against ``Hr``, complex ones fft/ifft against ``H``."""
    ntaps, nfft = filt["ntaps"], filt["nfft"]
    t_len = x.shape[-1]
    if t_len % stride:
        raise ValueError(f"block length {t_len} not divisible by stride {stride}")
    xfull = torch.cat([hist, x], dim=-1)
    new_hist = xfull[:, t_len:] if ntaps > 1 else hist
    segs, t_out, hop, nseg = _frame(xfull, ntaps, nfft)
    if xfull.is_complex():
        conv = torch.fft.ifft(torch.fft.fft(segs, dim=-1) * filt["H"][:, None, :], dim=-1)
    else:
        spec = torch.fft.rfft(segs, dim=-1) * filt["Hr"][:, None, :]
        conv = torch.fft.irfft(spec, n=nfft, dim=-1)
    # valid outputs of segment s: positions ntaps-1 .. nfft-1, which are
    # stream outputs s*hop .. s*hop + hop - 1
    good = conv[:, :, ntaps - 1 :].reshape(x.shape[0], nseg * hop)[:, :t_out]
    return new_hist, good[:, ::stride]
