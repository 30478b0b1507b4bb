"""Streaming block FIR filters as strided grouped convolutions.

Port of ``sdrreceiver_tpu.kernels.fir`` (the JAX package runs these outside
any Pallas kernel, so they are torch ops here too).  Semantics shared by
every FIR in the framework:

    y[c, n] = sum_k taps[c, k] * x[c, n - k]        n = 0, S, 2S, ...

with causal zero-initial history and the last ``ntaps - 1`` inputs carried
between blocks (the reference's FIRQueueBackToFront handoff,
jonti/dsp.cpp:163-173, without its one-sample-stale copy).

float32 convolutions on CUDA go through cuDNN, which by default computes
them in TF32 (about three decimal digits): on the 125-tap Hilbert at audio
rms ~22000 that is tens of int16 LSBs.  Every convolution here runs under
:func:`no_tf32`.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "no_tf32",
    "prepare_taps",
    "conv_block",
    "conv_block_planar",
    "fir_history_init_planar",
    "delay_apply",
]


@contextlib.contextmanager
def no_tf32():
    """Full float32 for cuDNN convolutions and CUDA matrix products inside
    the block; the previous settings are restored on exit."""
    conv, mm = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm


def prepare_taps(
    taps, channels: int | None = None, device: torch.device | str = "cpu"
) -> torch.Tensor:
    """Convolution-order taps ``c[k]`` (``[ntaps]`` shared or ``[C, ntaps]``
    per channel) -> reversed per-channel correlation kernels ``[C, ntaps]``
    f32 on ``device``, the form :func:`conv_block` consumes.  Shorter
    per-channel filters are padded with TRAILING zeros before stacking."""
    t = np.asarray(taps, dtype=np.float32)
    if t.ndim == 1:
        t = t[None, :]
    if channels is not None and t.shape[0] == 1 and channels != 1:
        t = np.broadcast_to(t, (channels, t.shape[1]))
    return torch.tensor(t[:, ::-1].copy(), device=device)


def _conv(xfull: torch.Tensor, rtaps: torch.Tensor, stride: int) -> torch.Tensor:
    """Grouped conv of ``xfull [N, C, ntaps-1+T]`` -> ``[N, C, T/stride]``."""
    with no_tf32():
        return F.conv1d(
            xfull, rtaps[:, None, :], stride=stride, groups=rtaps.shape[0]
        )


def conv_block(
    hist: torch.Tensor, x: torch.Tensor, rtaps: torch.Tensor, stride: int = 1
) -> tuple[torch.Tensor, torch.Tensor]:
    """One streaming FIR block step on a real ``[C, T]`` block.

    ``hist`` is the ``[C, ntaps-1]`` carried input history, ``rtaps`` the
    ``[C, ntaps]`` kernels from :func:`prepare_taps`; outputs sit at input
    positions 0, stride, 2*stride, ... (the reference's phase convention,
    halfbanddecimator.cpp:48-66, vfo.cpp:351-383).  Returns
    ``(new_hist [C, ntaps-1], y [C, T // stride])``."""
    t_len = x.shape[-1]
    if t_len % stride:
        raise ValueError(f"block length {t_len} not divisible by stride {stride}")
    xfull = torch.cat([hist, x], dim=-1)
    new_hist = xfull[:, t_len:] if rtaps.shape[1] > 1 else hist
    return new_hist, _conv(xfull[None], rtaps, stride)[0]


def fir_history_init_planar(
    channels: int, ntaps: int, device: torch.device | str
) -> torch.Tensor:
    """Zero planar history ``[2, C, ntaps-1]`` f32 (re plane, im plane)."""
    return torch.zeros(
        2, channels, max(ntaps - 1, 0), dtype=torch.float32, device=device
    )


def conv_block_planar(
    hist: torch.Tensor,
    x: tuple[torch.Tensor, torch.Tensor],
    rtaps: torch.Tensor,
    stride: int = 1,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Planar-complex form of :func:`conv_block`: ``hist [2, C, ntaps-1]``,
    ``x = (re, im)`` each ``[C, T]``; both planes run as one batch of 2."""
    t_len = x[0].shape[-1]
    if t_len % stride:
        raise ValueError(f"block length {t_len} not divisible by stride {stride}")
    xfull = torch.cat([hist, torch.stack(x)], dim=-1)
    new_hist = xfull[:, :, t_len:] if rtaps.shape[1] > 1 else hist
    out = _conv(xfull, rtaps, stride)
    return new_hist, (out[0], out[1])


def delay_apply(
    hist: torch.Tensor, x: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pure ``d``-sample delay line ``y[n] = x[n-d]`` with ``d = hist len``
    (the reference's DelayThing, jonti/dsp.h:79-126: it aligns the I arm
    with the 62-sample group delay of the 125-tap Hilbert)."""
    d = hist.shape[-1]
    if d == 0:
        return hist, x
    xfull = torch.cat([hist, x], dim=-1)
    t_len = x.shape[-1]
    return xfull[..., t_len:], xfull[..., :t_len]
