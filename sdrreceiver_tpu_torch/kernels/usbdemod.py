"""USB (upper-sideband) demodulation: delay - Hilbert, then int16 quantize.

Port of ``sdrreceiver_tpu.kernels.usbdemod``.  The reference demodulates per
sample (vfo.cpp:300-332):

    usb[n] = delay62(I)[n] - hilbert125(Q)[n]
    usb    = fir_usb(usb)            # only when filter_bandwidth > 0
    out[n] = short(usb * gain * 32768)

The raw float->short C cast is replaced by round-half-to-even and saturation,
exactly as in the JAX package.
"""

from __future__ import annotations

import torch

from . import design
from .fir import conv_block, delay_apply

__all__ = ["usb_init", "usb_block_planar", "quantize_i16"]


def usb_init(channels: int, device: torch.device | str) -> dict:
    """Carried state for the USB demod stage of one channel bucket: the
    62-sample delay line and the 125-tap Hilbert's history."""
    return {
        "delay_hist": torch.zeros(channels, design.HILBERT_DELAY, device=device),
        "hilb_hist": torch.zeros(channels, design.HILBERT_LEN - 1, device=device),
    }


def usb_block_planar(
    state: dict,
    x: tuple[torch.Tensor, torch.Tensor],
    hilb_rtaps: torch.Tensor,
) -> tuple[dict, torch.Tensor]:
    """Demodulate a planar ``(re, im)`` ``[C, T]`` block to USB audio
    ``[C, T]``; ``hilb_rtaps`` is ``prepare_taps(design.hilbert(), C)``."""
    xr, xi = x
    delay_hist, delayed = delay_apply(state["delay_hist"], xr)
    hilb_hist, hq = conv_block(state["hilb_hist"], xi, hilb_rtaps)
    return {"delay_hist": delay_hist, "hilb_hist": hilb_hist}, delayed - hq


def quantize_i16(audio: torch.Tensor, gains: torch.Tensor) -> torch.Tensor:
    """``int16(audio * gain * 32768)``: round half to even, then saturate.
    ``gains`` is ``[C]`` f32 (ini ``gain``/100, mainwindow.cpp:219)."""
    scaled = audio * (gains[:, None] * 32768.0)
    return torch.clamp(torch.round(scaled), -32768.0, 32767.0).to(torch.int16)
