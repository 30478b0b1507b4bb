"""Non-power-of-two "late" decimation: the /5 and /6 stages.

Port of ``sdrreceiver_tpu.kernels.polyphase``.  At 1.92 Msps (main out
240 kHz) and 288 ksps the /2 chain cannot reach the 48k-family audio rates,
so the reference decimates the last stage by 5 or 6 with a windowed-sinc FIR
evaluated only at the kept output phases (vfo.cpp:70-101 design,
vfo.cpp:334-387 phase-skipping loop).  Here that is one strided grouped
convolution over the planar complex signal; outputs fall at input positions
0, L, 2L, ... of each block (check==0 emits, vfo.cpp:351-368).
"""

from __future__ import annotations

import numpy as np
import torch

from . import design
from .fir import conv_block_planar

__all__ = ["late_decim_taps", "late_decim_apply"]


def late_decim_taps(target_rate: int, factor: int) -> np.ndarray:
    """Design the /L anti-alias FIR exactly as the reference does
    (vfo.cpp:82-87; gain=2 is deliberate there and reproduced)."""
    if factor < 2:
        raise ValueError("late decimation factor must be >= 2")
    return design.low_pass(
        gain=2.0,
        sampling_freq=float(target_rate * factor),
        cutoff_freq=target_rate / 2.0,
        transition_width=target_rate / float(factor - 1),
        win=design.Window.HAMMING,
    )


def late_decim_apply(
    hist: torch.Tensor,
    x: tuple[torch.Tensor, torch.Tensor],
    rtaps: torch.Tensor,
    factor: int,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Streaming /L step on a planar complex block: ``hist [2, C, ntaps-1]``,
    ``x = (re, im)`` each ``[C, T]`` (T divisible by L), ``rtaps`` from
    ``fir.prepare_taps``.  Returns ``(new_hist, (re, im) [C, T/L])``."""
    return conv_block_planar(hist, x, rtaps, factor)
