"""Time-shard halo exchange of streaming state (port of
``sdrreceiver_tpu.dist.halo``).

The reference's streaming state — every FIR carrying its last ``ntaps - 1``
inputs across blocks (FIRQueueBackToFront, jonti/dsp.cpp:163-173), the NCO
its phase (oscillator.cpp:39-50), the DC EMA its mean (sdrj.cpp:280) — is a
halo exchange once a block is split along time: shard ``i`` needs the last
samples of shard ``i-1``, and shard 0 the state carried from the previous
block.

The JAX package runs these functions inside ``shard_map`` over a ``time``
mesh axis.  Here each takes the list of the time shards this process
computes, in time order, each a planar ``(re, im)`` pair on its own
device; the collectives are copies between those devices.  Where a mesh's
shards span processes, ``span`` (``dist.multihost.ProcessSpan``) carries
the transfers that cross a process boundary; ``span=None`` means this
process computes every shard.

  * FIR/cascade halos: right shift of each shard's tail
    (:func:`right_halo`); shard 0 gets zeros, where the carried history goes
  * NCO phase: no traffic at all, shard offsets from the exact integer step
  * DC EMA: a shard-local prefix from a zero start, then an affine
    composition over the gathered per-shard totals
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import dc, fir, nco

__all__ = [
    "right_halo",
    "gather",
    "timeshard_cascade_local",
    "timeshard_mix_local",
    "timeshard_dc_local",
]


def _first(span) -> int:
    """Global index of this process's first shard."""
    return 0 if span is None else span.lo


def right_halo(xs: list[torch.Tensor], width: int, span=None) -> list[torch.Tensor]:
    """Each shard receives the last ``width`` time samples of its LEFT
    neighbour, on its own device; global shard 0 receives zeros.  ``xs[i]``
    is ``[..., T_local]``."""
    tails = [x[..., -width:] for x in xs]
    first = torch.zeros_like(tails[0]) if span is None else span.halo_from_left(tails[-1])
    return [first] + [t.to(x.device) for t, x in zip(tails[:-1], xs[1:])]


def _bcast_from_last(vs: list[torch.Tensor], device, span=None) -> torch.Tensor:
    """The last shard's value (the new carried state), on ``device``."""
    v = vs[-1] if span is None else span.from_last(vs[-1])
    return v.to(device)


def gather(vs: list[torch.Tensor], device, span=None) -> list[torch.Tensor]:
    """Every shard's value, in time order, on ``device`` (an all-gather)."""
    if span is None:
        return [v.to(device) for v in vs]
    return list(span.all_gather(torch.stack([v.to(device) for v in vs])).to(device))


def timeshard_cascade_local(
    hists: list[torch.Tensor],
    xs: list[tuple[torch.Tensor, torch.Tensor]],
    rtaps: torch.Tensor,
    span=None,
) -> tuple[list[torch.Tensor], list[tuple[torch.Tensor, torch.Tensor]]]:
    """Half-band /2 cascade over time shards.

    ``hists`` are the carried per-stage histories ``[2, C, taps-1]`` (only
    global shard 0 consumes them); ``xs`` the shards, each ``[C,
    T_local]`` planes with ``T_local`` divisible by ``2**len(hists)``.
    Returns (new histories on ``hists``' device, per-shard outputs)."""
    ys = list(xs)
    new_hists = []
    for hist in hists:
        width = hist.shape[-1]
        y2 = [torch.stack(y) for y in ys]
        lefts = right_halo(y2, width, span)
        if _first(span) == 0:
            lefts[0] = hist.to(lefts[0].device)
        new_hists.append(_bcast_from_last([y[..., -width:] for y in y2], hist.device, span))
        ys = [
            fir.conv_block_planar(left, y, rtaps.to(left.device), stride=2)[1]
            for left, y in zip(lefts, ys)
        ]
    return new_hists, ys


def timeshard_mix_local(
    state: dict,
    xs: list[tuple[torch.Tensor, torch.Tensor]],
    fs: int,
    t_local: int,
    span=None,
) -> tuple[dict, list[tuple[torch.Tensor, torch.Tensor]]]:
    """NCO mix over time shards, with no traffic between them.

    Shard ``i`` mixes from phase ``phase0 + (i * (f t_local mod fs) mod fs)``
    and the new carried phase is ``phase0 + (n * (f t_local mod fs) mod
    fs)``, mod fs: exact integers (int64, the JAX package's uint32 values),
    so sharded equals unsharded to the bit.  ``xs[i]`` are ``[T_local]`` or
    ``[C, T_local]`` planes."""
    n = len(xs) if span is None else span.n
    step = nco.block_step_mod(state, fs, t_local)
    ys = []
    for k, x in enumerate(xs):
        local = {key: v.to(x[0].device) for key, v in state.items()}
        local["phase"] = ((state["phase"] + ((_first(span) + k) * step) % fs) % fs).to(x[0].device)
        ys.append(nco.mix_block_planar(local, x, fs)[1])
    new_state = dict(state)
    new_state["phase"] = (state["phase"] + (n * step) % fs) % fs
    return new_state, ys


def timeshard_dc_local(
    mean: torch.Tensor,
    xs: list[tuple[torch.Tensor, torch.Tensor]],
    alpha: float = dc.DEFAULT_ALPHA,
    span=None,
) -> tuple[torch.Tensor, list[tuple[torch.Tensor, torch.Tensor]]]:
    """DC-EMA removal over time shards.

    ``mean`` is the carried planar mean ``[2]``; ``xs[i]`` are ``[T_local]``
    planes.  Within a shard: the closed-form prefix of ``kernels.dc`` from a
    zero start.  Across shards: each reduces to the affine map ``m -> A m +
    B`` with ``A = a^T_local``; the gathered ``B`` of every shard composes
    each shard's starting mean from the carried one, in the JAX package's
    order of float operations.  Returns (new mean on ``mean``'s device,
    per-shard outputs)."""
    x2s = [torch.stack(x) for x in xs]
    t_local = x2s[0].shape[-1]
    vs = [dc.zero_prefix(x2, alpha) for x2 in x2s]
    b_tot = gather([v[..., -1] for v in vs], mean.device, span)
    a_t = torch.tensor(np.float32(dc.decay_pow(alpha, float(t_local))), device=mean.device)
    starts = [mean]  # starts[j]: the mean entering shard j
    for b in b_tot:
        starts.append(a_t * starts[-1] + b)
    ys = []
    for k, (x2, v) in enumerate(zip(x2s, vs)):
        a_n1 = dc._decay(alpha, torch.arange(1, t_local + 1, device=x2.device))
        m = a_n1[None, :] * starts[_first(span) + k].to(x2.device)[:, None] + v
        y = x2 - m
        ys.append((y[0], y[1]))
    return starts[-1], ys
