"""ShardedReceiver: the receiver over a ``(time, chan)`` device mesh (port
of ``sdrreceiver_tpu.dist.sharded``).

The front end (DC + per-group mix + half-band cascade, at the full input
rate) runs per time shard: DC through the halo composition
(``dist.halo``, the fused ingest+DC kernel never runs under a mesh), and
the cascaded groups through the mix-cascade kernel on each shard, with the
warm-up-halo scheme of the single-device receiver: shard ``i`` prepends
``p`` input samples from its left neighbour (shard 0 from the carried
``xtail``), starts its NCO ``p`` samples early, and drops the first ``p >>
d`` outputs.  Two or more cascaded groups share one merged kernel call per
shard.  Groups that only mix, or whose shard is shorter than the warm-up,
take the stateful halo path.

The group outputs are gathered onto the mesh's home device; each bucket
with at least ``n_chan`` channels is split into contiguous channel ranges
over the ``chan`` devices, and each range runs the single-device bucket
step (``CompiledReceiver._bucket_step``) unchanged, on the stateful path
(no bucket kernel runs under a mesh, as in the JAX package).  So taps, late
/5 /6, overlap-save and IQ topics are the same code in both receivers.
Where a time row spans processes (a global mesh whose process's device
count is not a multiple of ``n_chan``), each process computes the time
shards of its rows whole (the front repeated across the row, as the JAX
``shard_map`` repeats it over the chan axis) and only the channel ranges
``Mesh.chan_owners`` gives it, each on its device at that chan position;
one ``"chan"`` exchange a split bucket then gathers every range's new
state and outputs from the processes of its channel group.

State and outputs live on the home device in exactly the single-device
layout: ``export_state`` / ``import_state``, the checkpoints and the burst
entries are inherited, and a checkpoint crosses between sharded and
unsharded receivers of either package.

Every transfer between devices goes through ``ShardedReceiver._move``,
once per exchange for every shard together: the raw block out to the
shards, the DC totals in and the starting means out, the halos (with the
shard NCO phases), the input tail and the group outputs in, and per split
bucket its channel ranges out and back.  Where the mesh spans processes,
what crosses a process boundary (among the processes of a time group: the
halo into the process's first shard, the DC totals, the input tail, the
group outputs and the last shard's cascade histories; among those of a
channel group: each split bucket's channel ranges) is one call of
``ProcessSpan.exchange`` each: an NCCL
collective on the home card's tensors where every process holds cards no
other process holds, else a gloo call on host buffers (:attr:`exchange`
says which).  The exchange names its destination device.  With two cards
a process, a source on the second card reaches the home card through one
of the process's own transfers: the NCCL group binds one card a process,
so one communicator serves every shard of it.  Between two transfers or
exchanges each card computes on its own, so on the card
(``cuda_graphs=True``, the default) each step entry replays one CUDA graph
per phase and card (``dist.meshgraph``), the counterpart of the JAX
package's one compiled ``shard_map`` step: the transfers are copies
between static buffers, the NCCL collectives are captured inside the
graphs, and a gloo exchange is a host call between two phases, through
static pinned buffers.  ``cuda_graphs=False`` runs the same step eagerly,
its transfers as plain ``.to()`` copies.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from ..graph.compiler import CompiledReceiver, _is_planar_pair
from ..graph.cudagraph import flatten
from ..graph.plan import ReceiverPlan
from ..kernels import ingest
from . import halo
from .mesh import CHAN_AXIS, TIME_AXIS, Mesh, local_devices, make_mesh
from .meshgraph import MeshGraphs

__all__ = ["ShardedReceiver"]


def _chan_dim(key: str) -> int:
    """Channel axis of a bucket state leaf: planar ``[2, C, ...]`` pairs
    carry it second."""
    return 1 if _is_planar_pair(key) else 0


def _map_states(fn, trees: list, prefix: str):
    """``fn(path, leaves)`` over nested dict/list states of one structure,
    ``leaves`` holding each tree's leaf at ``path``."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _map_states(fn, [t[k] for t in trees], f"{prefix}{k}/") for k in t0}
    if isinstance(t0, list):
        return [_map_states(fn, [t[i] for t in trees], f"{prefix}{i}/") for i in range(len(t0))]
    return fn(prefix[:-1], trees)


def _refill(tree, leaves):
    """``tree``'s nested dicts/lists around the next leaves of the iterator
    ``leaves`` (in :func:`~..graph.cudagraph.flatten` order)."""
    if isinstance(tree, dict):
        return {k: _refill(v, leaves) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_refill(v, leaves) for v in tree]
    return next(leaves)


def _chan_items(new: dict, outs: dict, bk: str, topics: list[str]) -> list[torch.Tensor]:
    """One channel range's results, each with the channel axis first: the
    new state's leaves, the audio ``[c, t]`` and, where ``topics`` (the
    range's subs in order) are tapped, their taps ``[c, 2, n]``."""
    items = [v.movedim(_chan_dim(k), 0) for k, v in flatten(new, bk + "/")]
    items.append(outs[f"pcm/{bk}"].reshape(len(topics), -1))
    if f"tap/{topics[0]}" in outs:
        items.append(torch.stack([outs[f"tap/{t}"] for t in topics]))
    return items


def _span_bytes(t: torch.Tensor, m: int) -> int:
    """Bytes of ``t`` padded to ``m`` channels, rounded up to 8 so that
    every item of a packed row starts aligned for its dtype."""
    return -(-m * t[:1].numel() * t.element_size() // 8) * 8


def _pack(items: list[torch.Tensor], m: int) -> torch.Tensor:
    """``items`` (channel axis first) padded to ``m`` channels each, as one
    row of bytes: every range of a bucket packs to one length."""
    rows = []
    for t in items:
        if t.shape[0] < m:
            t = torch.cat([t, t.new_zeros((m - t.shape[0], *t.shape[1:]))])
        b = t.contiguous().view(-1).view(torch.uint8)
        rows += [b, b.new_zeros(_span_bytes(t, m) - b.numel())]
    return torch.cat(rows)


def _unpack(rows: torch.Tensor, like: list[torch.Tensor], counts: list[int], m: int):
    """The inverse of :func:`_pack` over every range (``rows``: each
    range's row of bytes in column order, ``counts`` the ranges' channels):
    each item of ``like`` (one range's, for shapes and dtypes) over the
    whole bucket, channel axis first."""
    out, at = [], 0
    for t in like:
        n = m * t[:1].numel() * t.element_size()
        shape = (m, *t.shape[1:])
        parts = [r[at:at + n].view(t.dtype).view(shape)[:c] for r, c in zip(rows, counts)]
        out.append(torch.cat(parts))
        at += _span_bytes(t, m)
    return out


class _ChanSlice:
    """Channels ``[lo, hi)`` of bucket ``bk`` on one ``chan`` device: the
    constants the single-device bucket step reads, sliced to the range, so
    that step runs here unchanged.  ``tap_all``: tap every channel of the
    range (a range whose results cross processes packs its taps whole)."""

    _bucket_step = CompiledReceiver._bucket_step
    _tap = CompiledReceiver._tap

    def __init__(self, rx: CompiledReceiver, bk: str, lo: int, hi: int, device: torch.device,
                 tap_all: tuple[str, ...] = ()):
        self.device = device
        self.emit_taps = tuple(rx.emit_taps) + tap_all
        self.tap_samples = rx.tap_samples
        self._bucket_mc: dict = {}
        self._c = {k: v[lo:hi].to(device) for k, v in rx._c.items() if k.startswith(bk + "/")}
        self._oss = {}
        if bk in rx._oss:
            f = rx._oss[bk]
            self._oss[bk] = dict(f, H=f["H"][lo:hi].to(device), Hr=f["Hr"][lo:hi].to(device))


class ShardedReceiver(CompiledReceiver):
    """:class:`CompiledReceiver` over ``mesh``: a :class:`~.mesh.Mesh`, or a
    shape ``(n_time, n_chan)`` over :func:`~.mesh.local_devices` of
    ``device`` (the card unless ``device="cpu"``).  Takes every
    CompiledReceiver option; the block must be a multiple of the plan's
    divisor times ``n_time``.  ``cuda_graphs`` defaults to True, whether or
    not the mesh spans processes (phase graphs on the card, eager on the
    CPU)."""

    _graphs_type = MeshGraphs

    def __init__(
        self,
        plan: ReceiverPlan,
        mesh: Mesh | tuple[int, int],
        block_samples: int | None = None,
        device: torch.device | str | None = None,
        **kwargs,
    ):
        if not isinstance(mesh, Mesh):
            n_time, n_chan = mesh
            mesh = make_mesh(n_time, n_chan, local_devices(n_time * n_chan, device or "cuda"))
        elif device is not None and torch.device(device).type != mesh.home.type:
            raise ValueError(f"device {device} is not the mesh's ({mesh.home})")
        self.mesh = mesh
        self.n_time = mesh.shape[TIME_AXIS]
        self.n_chan = mesh.shape[CHAN_AXIS]
        need = plan.block_divisor() * self.n_time
        block = int(block_samples or plan.block_samples)
        if block % need:
            raise ValueError(
                f"block of {block} samples must be a multiple of divisor*n_time = {need}"
            )
        self._rows = mesh.rows()
        self._span = None
        # every transfer of the step, one call per exchange (swapped by
        # dist.meshgraph for its static buffers and phase boundaries)
        self._move = halo.to_devices
        if mesh.multiprocess:
            from .multihost import ProcessSpan

            self._span = ProcessSpan(mesh)
        super().__init__(plan, block, device=mesh.home, **kwargs)
        # each bucket of at least n_chan channels: contiguous ranges over
        # the chan positions, each with the constants of its range on the
        # device of this process that computes it (Mesh.chan_owners; None:
        # a range another process of the channel group computes)
        self._chan_parts: dict[str, list] = {}
        if self.n_chan > 1:
            owners = mesh.chan_owners()
            split = len(mesh.row_ranks()) > 1
            for g in plan.groups:
                for bi, b in enumerate(g.buckets):
                    if b.channels < self.n_chan:
                        continue
                    bk = f"g{g.index}/b{bi}"
                    tap = split and any(s.topic in self.emit_taps for s in b.subs)
                    parts = []
                    for j, idx in enumerate(np.array_split(np.arange(b.channels), self.n_chan)):
                        lo, hi = int(idx[0]), int(idx[-1]) + 1
                        sub = dataclasses.replace(b, subs=b.subs[lo:hi])
                        taps = tuple(s.topic for s in sub.subs) if tap else ()
                        q, i = owners[j]
                        parts.append((lo, hi, sub, None if q != mesh.rank else
                                      _ChanSlice(self, bk, lo, hi, mesh.devices[i][j], taps)))
                    self._chan_parts[bk] = parts

    @property
    def exchange(self) -> str | None:
        """The library of the exchanges across processes, ``"nccl"`` or
        ``"gloo"``; None where the mesh lies in this process."""
        return None if self._span is None else self._span.backend

    @property
    def _tspan(self):
        """The span of the time exchanges: None where this process computes
        every time shard (a mesh in one process, or a time group of this
        process alone)."""
        span = self._span
        return span if span is not None and span.time else None

    # --------------------------------------------------------- transfers
    @contextlib.contextmanager
    def _transfers(self, move, exchange):
        """Make the step's transfers through ``move`` and, where the mesh
        spans processes, its exchanges through ``exchange``
        (``dist.meshgraph``'s static buffers and phase boundaries) while
        the context lasts."""
        span = self._span
        prev = self._move, span and span.exchange
        self._move = move
        if span is not None:
            span.exchange = exchange
        try:
            yield
        finally:
            self._move = prev[0]
            if span is not None:
                span.exchange = prev[1]

    def _build_kernels(self) -> None:
        super()._build_kernels()
        # the stateful cascade's taps on each time shard's device, built once
        self._hb1_shards = [self._hb1.to(dev) for _, dev in self._shard_devices()]

    # ------------------------------------------------------- time shards
    def _shard_devices(self) -> list[tuple[int, torch.device]]:
        return [(i, self.mesh.own(i)[0][1]) for i in self._rows]

    def _ingest(self, state: dict, raw: torch.Tensor):
        """This process's time shards of ``raw`` on their devices, planar,
        with DC removed by the halo composition."""
        t_local = self.block // self.n_time
        shards = self._shard_devices()
        rs = self._move([raw[2 * i * t_local:2 * (i + 1) * t_local] for i, _ in shards],
                        [dev for _, dev in shards])
        xs = [ingest.u8_iq_to_planar(r) if r.dtype == torch.uint8
              else ingest.f32_pairs_to_planar(r) for r in rs]
        if not self.plan.dc_correct:
            return state["dc"], xs
        return halo.timeshard_dc_local(state["dc"], xs, span=self._tspan, move=self._move)

    def _input_tail(self, xs, n: int | None) -> torch.Tensor:
        t_local = self.block // self.n_time
        w = min(n, t_local) if n else t_local
        k = min(-(-n // t_local), self.n_time) if n else self.n_time
        tails = halo.gather([torch.stack((xr[-w:], xi[-w:])) for xr, xi in xs],
                            self.device, self._tspan, self._move)
        return torch.cat(tails[-k:], dim=-1)[:, -n:] if n else torch.cat(tails, dim=-1)

    def _left_halos(self, state: dict, xs, p: int, phases: torch.Tensor):
        """The left neighbour's last ``p`` inputs (global shard 0's from the
        carried xtail) and ``phases`` on every shard, in one transfer."""
        head, srcs, devs = halo.halo_moves(
            [torch.stack((xr[-p:], xi[-p:])) for xr, xi in xs], p, self._tspan,
            first=state["xtail"][:, -p:],
        )
        shard_devs = [dev for _, dev in self._shard_devices()]
        moved = self._move(srcs + [phases] * len(xs), devs + shard_devs)
        lefts, starts = moved[:len(srcs)], moved[len(srcs):]
        return (lefts if head is None else [head] + lefts), starts

    def _gather_time(self, per_shard: dict) -> dict:
        """Per group, per-shard planar ``[C, t]`` pairs -> the whole block
        on the home device, every group in one transfer."""
        stacked = [[torch.stack(p) for p in ps] for ps in per_shard.values()]
        if self._tspan is None:
            here = iter(halo.gather([t for ts in stacked for t in ts], self.device,
                                    move=self._move))
            gathered = [[next(here) for _ in ts] for ts in stacked]
        else:  # every process's shards; gloo gathers one shape at a time
            gathered = [halo.gather(ts, self.device, self._tspan, self._move) for ts in stacked]
        zs = {}
        for gi, parts in zip(per_shard, gathered):
            z = torch.cat(parts, dim=-1)
            zs[f"g{gi}"] = (z[0], z[1])
        return zs

    def _stateful_group(self, gs: dict, xs):
        t_local = self.block // self.n_time
        nco_state, zs = halo.timeshard_mix_local(gs["nco"], xs, self.plan.fs, t_local,
                                                 self._tspan, self._move)
        hists, zs = halo.timeshard_cascade_local(gs["cascade"], zs, self._hb1_shards,
                                                 self._tspan, self._move)
        return nco_state, hists, zs

    # ------------------------------------------------------ chan ranges
    def _bucket_step(self, g, bi: int, bs: dict, z, outputs: dict, state: dict) -> dict:
        """A bucket of at least ``n_chan`` channels: the channel ranges of
        this process's devices out to them in one transfer, the
        single-device bucket step on each, the outputs and new state back in
        one; where the row spans processes, every range's results then in
        one ``"chan"`` exchange."""
        bk = f"g{g.index}/b{bi}"
        parts = self._chan_parts.get(bk)
        if parts is None:
            return super()._bucket_step(g, bi, bs, z, outputs, state)
        mine = [p for p in parts if p[3] is not None]
        srcs, devs, sub_trees = [], [], []
        for lo, hi, _, part in mine:
            sub_bs = _map_states(
                lambda key, v: v[0].narrow(_chan_dim(key), lo, hi - lo), [bs], bk + "/"
            )
            sub_trees.append(sub_bs)
            leaves = [v for _, v in flatten(sub_bs)] + [z[0], z[1]]
            srcs += leaves
            devs += [part.device] * len(leaves)
        moved = iter(self._move(srcs, devs))
        results = []
        for (_, _, sub, part), sub_bs in zip(mine, sub_trees):
            sub_g = dataclasses.replace(
                g, buckets=tuple(sub if k == bi else b for k, b in enumerate(g.buckets))
            )
            sub_bs = _refill(sub_bs, moved)
            zp = (next(moved), next(moved))
            outs: dict = {}
            new = part._bucket_step(sub_g, bi, sub_bs, zp, outs, state)
            results.append((new, outs))
        back = [v for new, outs in results
                for v in [t for _, t in flatten(new)] + list(outs.values())]
        home = iter(self._move(back, [self.device] * len(back)))
        homed = [(_refill(new, home), {k: next(home) for k in outs}) for new, outs in results]
        if len(mine) < len(parts):
            return self._chan_exchange(bk, parts, homed, outputs)
        new_parts, pcm = [], []
        for new, outs in homed:
            new_parts.append(new)
            pcm.append(outs.pop(f"pcm/{bk}"))
            outputs.update(outs)
        outputs[f"pcm/{bk}"] = torch.cat(pcm)
        return _map_states(
            lambda key, vs: torch.cat(vs, dim=_chan_dim(key)), new_parts, bk + "/",
        )

    def _chan_exchange(self, bk: str, parts, homed, outputs: dict) -> dict:
        """Every range of a bucket split across the processes of a channel
        group, from this process's ranges' results on the home device
        (``homed``): each range's new state, audio and taps packed into one
        row of bytes, padded to the largest range (``all_gather`` needs one
        length), as many rows from every process (zero rows where it
        computes fewer ranges than another), one ``"chan"`` exchange of
        them, the ranges picked out in column order (``chan_slots``) and
        the padding cut off.  Returns the bucket's new state; adds its
        outputs to ``outputs``."""
        span = self._span
        m = max(hi - lo for lo, hi, _, _ in parts)
        topics = [[s.topic for s in sub.subs] for _, _, sub, _ in parts]
        local = [ts for ts, p in zip(topics, parts) if p[3] is not None]
        items = [_chan_items(new, outs, bk, ts) for (new, outs), ts in zip(homed, local)]
        packed = [_pack(it, m) for it in items]
        packed += [torch.zeros_like(packed[0])] * (span.chan_pad - len(packed))
        rows = span.exchange("chan", torch.stack(packed), self.device)
        full = _unpack([rows[s] for s in span.chan_slots], items[0],
                       [hi - lo for lo, hi, _, _ in parts], m)
        new, leaves = homed[0][0], iter(full)
        new = _refill(new, (t.movedim(0, _chan_dim(k)) for (k, _), t
                            in zip(flatten(new, bk + "/"), leaves)))
        pcm = next(leaves)
        taps = next(leaves, None)
        if taps is not None:
            for ci, t in enumerate(tp for ts in topics for tp in ts):
                if t in self.emit_taps:
                    outputs[f"tap/{t}"] = taps[ci]
        outputs[f"pcm/{bk}"] = pcm.reshape(-1)
        return new
