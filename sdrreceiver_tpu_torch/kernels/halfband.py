"""Half-band /2 decimation cascades (port of
``sdrreceiver_tpu.kernels.halfband``).

Reference: up to 8 chained 11-tap HalfBandDecimator objects per VFO
(vfo.cpp:127-133, halfbanddecimator.cpp:43-72).  Stage k maps
``[C, T/2^k] -> [C, T/2^(k+1)]`` computing only the kept (even) phases, with
10 samples of carried history per stage per channel.
"""

from __future__ import annotations

import torch

from .fir import conv_block_planar, fir_history_init_planar

__all__ = [
    "cascade_init_planar",
    "cascade_apply_planar",
    "cascade_tails_from_tail",
]


def cascade_init_planar(
    channels: int, stages: int, device: torch.device | str
) -> list[torch.Tensor]:
    """Zero planar history ``[2, C, 10]`` f32 per 11-tap stage."""
    return [fir_history_init_planar(channels, 11, device) for _ in range(stages)]


def cascade_apply_planar(
    hists: list[torch.Tensor],
    x: tuple[torch.Tensor, torch.Tensor],
    rtaps: torch.Tensor,
) -> tuple[list[torch.Tensor], tuple[torch.Tensor, torch.Tensor]]:
    """Run planar ``x`` ``[C, T]`` through the /2 cascade -> ``[C, T/2^S]``."""
    new_hists = []
    y = x
    for hist in hists:
        hist, y = conv_block_planar(hist, y, rtaps, stride=2)
        new_hists.append(hist)
    return new_hists, y


def cascade_tails_from_tail(
    tail: tuple[torch.Tensor, torch.Tensor],
    rtaps: torch.Tensor,
    stages: int,
) -> list[torch.Tensor]:
    """Canonical per-stage histories ``[2, C, 10]`` re-derived from a stream
    TAIL (the last ``cuda.frontend.warmup_len(stages)`` samples of a
    cascade's input, already mixed).

    An FIR cascade forgets its initialization after its extent, so running
    the tail through a ZERO-initialized cascade leaves every stage's last 10
    input samples — exactly the streaming state — correct.  This is what
    lets the stateless mix-cascade kernel keep the canonical checkpoint
    layout."""
    c = tail[0].shape[0]
    y = tail
    tails: list[torch.Tensor] = []
    for _s in range(stages):
        tails.append(torch.stack([y[0][:, -10:], y[1][:, -10:]]))
        _, y = conv_block_planar(
            fir_history_init_planar(c, 11, y[0].device), y, rtaps, stride=2
        )
    return tails
