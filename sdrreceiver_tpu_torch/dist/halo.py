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
device; the collectives are copies between those devices, made by
``move(tensors, devices)`` (default :func:`to_devices`), once per exchange
and for every shard together: ``dist.meshgraph`` passes a ``move`` that
makes each call a boundary between two phases of CUDA graphs.  Nothing
else in these functions crosses devices: per-shard constants come from the
caller or are built once per device.  Where a mesh's shards span
processes, ``span`` (``dist.multihost.ProcessSpan``) carries the transfers
that cross a process boundary, each one call of its ``exchange`` hook
(which ``dist.meshgraph`` swaps, as it swaps ``move``): the halo into this
process's first shard, the last shard's cascade history, the gathers,
each an NCCL collective or a gloo call (``ProcessSpan.transport``) among
the processes of this process's time group, each shard published by one
of them (``Mesh.publishers``); ``span=None`` means this process computes
every shard (one process, or a time group of this process alone: where
each process holds a run of columns of one time row, each computes its
row whole, as the JAX ``shard_map`` repeats the front over the chan axis,
and nothing of the front crosses between them).

  * FIR/cascade halos: right shift of each shard's tail
    (:func:`right_halo`); shard 0 gets zeros, where the carried history goes
  * NCO phase: no traffic at all, shard offsets from the exact integer step
  * DC EMA: a shard-local prefix from a zero start, then an affine
    composition over the gathered per-shard totals
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from ..kernels import dc, fir, nco

__all__ = [
    "to_devices",
    "halo_moves",
    "right_halo",
    "gather",
    "timeshard_cascade_local",
    "timeshard_mix_local",
    "timeshard_dc_local",
]


def _first(span) -> int:
    """Global index of this process's first shard."""
    return 0 if span is None else span.lo


Move = Callable[[Sequence[torch.Tensor], Sequence[torch.device]], list]


def to_devices(ts: Sequence[torch.Tensor], devs: Sequence[torch.device]) -> list[torch.Tensor]:
    """The eager transfer: each tensor on its device (itself where it is
    there already)."""
    return [t.to(d) for t, d in zip(ts, devs)]


def halo_moves(xs: list[torch.Tensor], width: int, span=None, first=None):
    """The transfers of :func:`right_halo`, for a caller that makes them
    in one ``move`` with its own: ``(head, srcs, devices)``.  The halos are
    ``[head] + move(srcs, devices)``, or ``move(srcs, devices)`` where
    ``head`` is None (``first`` moved to global shard 0).  Across
    processes ``head`` comes from the publisher of the shard before this
    process's first, and this process sends the tail of its shard
    ``span.halo_k`` (mostly its last) to the processes whose first shard
    follows that one."""
    tails = [x[..., -width:] for x in xs]
    head = None if span is None else span.exchange("halo", tails[span.halo_k], xs[0].device)
    srcs, devs = tails[:-1], [x.device for x in xs[1:]]
    if first is not None and _first(span) == 0:
        return None, [first] + srcs, [xs[0].device] + devs
    return (torch.zeros_like(tails[0]) if head is None else head), srcs, devs


def right_halo(xs: list[torch.Tensor], width: int, span=None) -> list[torch.Tensor]:
    """Each shard receives the last ``width`` time samples of its LEFT
    neighbour, on its own device; global shard 0 receives zeros.  ``xs[i]``
    is ``[..., T_local]``."""
    head, srcs, devs = halo_moves(xs, width, span)
    return [head] + to_devices(srcs, devs)


def gather(vs: list[torch.Tensor], device, span=None, move: Move = to_devices) -> list[torch.Tensor]:
    """Every shard's value, in time order, on ``device`` (an all-gather:
    across processes, of the values of the shards this process publishes,
    padded with zeros to ``span.pad``)."""
    device = torch.device(device)
    if span is None:
        return move(vs, [device] * len(vs))
    mine = [vs[k] for k in span.published]
    here = move(mine, [device] * len(mine)) if mine else []
    pad = [torch.zeros(vs[0].shape, dtype=vs[0].dtype, device=device)] * (span.pad - len(here))
    rows = span.exchange("gather", torch.stack(here + pad), device)
    return [rows[s] for s in span.slots]


def timeshard_cascade_local(
    hists: list[torch.Tensor],
    xs: list[tuple[torch.Tensor, torch.Tensor]],
    rtaps,
    span=None,
    move: Move = to_devices,
) -> tuple[list[torch.Tensor], list[tuple[torch.Tensor, torch.Tensor]]]:
    """Half-band /2 cascade over time shards.

    ``hists`` are the carried per-stage histories ``[2, C, taps-1]`` (only
    global shard 0 consumes them); ``xs`` the shards, each ``[C,
    T_local]`` planes with ``T_local`` divisible by ``2**len(hists)``;
    ``rtaps`` the prepared taps, or a list of them on each shard's device.
    One transfer per stage: the halos, the carried history to shard 0 and
    the last shard's tail (the new history).  Returns (new histories on
    ``hists``' device, per-shard outputs)."""
    rts = (list(rtaps) if isinstance(rtaps, (list, tuple))
           else [rtaps.to(x[0].device) for x in xs])
    ys = list(xs)
    new_hists = []
    for hist in hists:
        width = hist.shape[-1]
        y2 = [torch.stack(y) for y in ys]
        head, srcs, devs = halo_moves(y2, width, span, first=hist)
        last = y2[-1][..., -width:]
        if span is None:
            moved = move(srcs + [last], devs + [hist.device])
            new_hists.append(moved.pop())
        else:
            moved = move(srcs, devs)
            new_hists.append(span.exchange("last", last, hist.device))
        lefts = moved if head is None else [head] + moved
        ys = [
            fir.conv_block_planar(left, y, rt, stride=2)[1]
            for left, y, rt in zip(lefts, ys, rts)
        ]
    return new_hists, ys


def timeshard_mix_local(
    state: dict,
    xs: list[tuple[torch.Tensor, torch.Tensor]],
    fs: int,
    t_local: int,
    span=None,
    move: Move = to_devices,
) -> tuple[dict, list[tuple[torch.Tensor, torch.Tensor]]]:
    """NCO mix over time shards, with no traffic between them but the
    state's way out to them (one transfer).

    Shard ``i`` mixes from phase ``phase0 + (i * (f t_local mod fs) mod fs)``
    and the new carried phase is ``phase0 + (n * (f t_local mod fs) mod
    fs)``, mod fs: exact integers (int64, the JAX package's uint32 values),
    so sharded equals unsharded to the bit.  ``xs[i]`` are ``[T_local]`` or
    ``[C, T_local]`` planes."""
    n = len(xs) if span is None else span.n
    step = nco.block_step_mod(state, fs, t_local)
    keys = list(state)
    srcs, devs = [], []
    for k, x in enumerate(xs):
        local = dict(state)
        local["phase"] = (state["phase"] + ((_first(span) + k) * step) % fs) % fs
        srcs += [local[key] for key in keys]
        devs += [x[0].device] * len(keys)
    moved = iter(move(srcs, devs))
    ys = []
    for x in xs:
        local = {key: next(moved) for key in keys}
        ys.append(nco.mix_block_planar(local, x, fs)[1])
    new_state = dict(state)
    new_state["phase"] = (state["phase"] + (n * step) % fs) % fs
    return new_state, ys


def timeshard_dc_local(
    mean: torch.Tensor,
    xs: list[tuple[torch.Tensor, torch.Tensor]],
    alpha: float = dc.DEFAULT_ALPHA,
    span=None,
    move: Move = to_devices,
) -> tuple[torch.Tensor, list[tuple[torch.Tensor, torch.Tensor]]]:
    """DC-EMA removal over time shards.

    ``mean`` is the carried planar mean ``[2]``; ``xs[i]`` are ``[T_local]``
    planes.  Within a shard: the closed-form prefix of ``kernels.dc`` from a
    zero start.  Across shards: each reduces to the affine map ``m -> A m +
    B`` with ``A = a^T_local``; the gathered ``B`` of every shard composes
    each shard's starting mean from the carried one, in the JAX package's
    order of float operations.  Two transfers: the totals to ``mean``'s
    device, the starting means back.  ``A`` and the per-shard ramp
    ``a^(n+1)`` are built once per device and size.  Returns (new mean on
    ``mean``'s device, per-shard outputs)."""
    x2s = [torch.stack(x) for x in xs]
    t_local = x2s[0].shape[-1]
    vs = [dc.zero_prefix(x2, alpha) for x2 in x2s]
    b_tot = gather([v[..., -1] for v in vs], mean.device, span, move)
    a_t = dc.decay_scalar(alpha, t_local, mean.device)
    starts = [mean]  # starts[j]: the mean entering shard j
    for b in b_tot:
        starts.append(a_t * starts[-1] + b)
    m0s = move([starts[_first(span) + k] for k in range(len(xs))], [x2.device for x2 in x2s])
    ys = []
    for x2, v, m0 in zip(x2s, vs, m0s):
        m = dc.decay_ramp(alpha, t_local, x2.device)[None, :] * m0[:, None] + v
        y = x2 - m
        ys.append((y[0], y[1]))
    return starts[-1], ys
