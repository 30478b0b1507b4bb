"""Non-power-of-two "late" decimation (/5, /6): the filter design only.

Port of ``sdrreceiver_tpu.kernels.polyphase.late_decim_taps``; the planner
needs it to describe every plan.  The streaming /L stage itself
(``late_decim_apply``) is not ported yet, and ``CompiledReceiver`` refuses
plans that would run it.
"""

from __future__ import annotations

import numpy as np

from . import design

__all__ = ["late_decim_taps"]


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
