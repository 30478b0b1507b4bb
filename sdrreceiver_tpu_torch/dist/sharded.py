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

State and outputs live on the home device in exactly the single-device
layout: ``export_state`` / ``import_state``, the checkpoints and the burst
entries are inherited, and a checkpoint crosses between sharded and
unsharded receivers of either package.

Every transfer between devices goes through ``ShardedReceiver._move``,
once per exchange for every shard together: the raw block out to the
shards, the DC totals in and the starting means out, the halos (with the
shard NCO phases), the input tail and the group outputs in, and per split
bucket its channel ranges out and back.  Where the mesh spans processes,
what crosses a process boundary (the halo into the process's first shard,
the DC totals, the input tail, the group outputs and the last shard's
cascade histories) is one call of ``ProcessSpan.exchange`` each: an NCCL
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


class _ChanSlice:
    """Channels ``[lo, hi)`` of bucket ``bk`` on one ``chan`` device: the
    constants the single-device bucket step reads, sliced to the range, so
    that step runs here unchanged."""

    _bucket_step = CompiledReceiver._bucket_step
    _tap = CompiledReceiver._tap

    def __init__(self, rx: CompiledReceiver, bk: str, lo: int, hi: int, device: torch.device):
        self.device = device
        self.emit_taps = rx.emit_taps
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
        # the chan devices of this process's first time row
        self._chan_parts: dict[str, list] = {}
        if self.n_chan > 1:
            devs = mesh.devices[self._rows[0]]
            for g in plan.groups:
                for bi, b in enumerate(g.buckets):
                    if b.channels < self.n_chan:
                        continue
                    bk = f"g{g.index}/b{bi}"
                    parts = []
                    for dev, idx in zip(devs, np.array_split(np.arange(b.channels), self.n_chan)):
                        lo, hi = int(idx[0]), int(idx[-1]) + 1
                        sub = dataclasses.replace(b, subs=b.subs[lo:hi])
                        parts.append((lo, hi, sub, _ChanSlice(self, bk, lo, hi, dev)))
                    self._chan_parts[bk] = parts

    @property
    def exchange(self) -> str | None:
        """The library of the exchanges across processes, ``"nccl"`` or
        ``"gloo"``; None where the mesh lies in this process."""
        return None if self._span is None else self._span.backend

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
        return [(i, self.mesh.devices[i][0]) for i in self._rows]

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
        return halo.timeshard_dc_local(state["dc"], xs, span=self._span, move=self._move)

    def _input_tail(self, xs, n: int | None) -> torch.Tensor:
        t_local = self.block // self.n_time
        w = min(n, t_local) if n else t_local
        k = min(-(-n // t_local), self.n_time) if n else self.n_time
        tails = halo.gather([torch.stack((xr[-w:], xi[-w:])) for xr, xi in xs],
                            self.device, self._span, self._move)
        return torch.cat(tails[-k:], dim=-1)[:, -n:] if n else torch.cat(tails, dim=-1)

    def _left_halos(self, state: dict, xs, p: int, phases: torch.Tensor):
        """The left neighbour's last ``p`` inputs (global shard 0's from the
        carried xtail) and ``phases`` on every shard, in one transfer."""
        head, srcs, devs = halo.halo_moves(
            [torch.stack((xr[-p:], xi[-p:])) for xr, xi in xs], p, self._span,
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
        if self._span is None:
            here = iter(halo.gather([t for ts in stacked for t in ts], self.device,
                                    move=self._move))
            gathered = [[next(here) for _ in ts] for ts in stacked]
        else:  # every process's shards; gloo gathers one shape at a time
            gathered = [halo.gather(ts, self.device, self._span, self._move) for ts in stacked]
        zs = {}
        for gi, parts in zip(per_shard, gathered):
            z = torch.cat(parts, dim=-1)
            zs[f"g{gi}"] = (z[0], z[1])
        return zs

    def _stateful_group(self, gs: dict, xs):
        t_local = self.block // self.n_time
        nco_state, zs = halo.timeshard_mix_local(gs["nco"], xs, self.plan.fs, t_local,
                                                 self._span, self._move)
        hists, zs = halo.timeshard_cascade_local(gs["cascade"], zs, self._hb1_shards,
                                                 self._span, self._move)
        return nco_state, hists, zs

    # ------------------------------------------------------ chan ranges
    def _bucket_step(self, g, bi: int, bs: dict, z, outputs: dict, state: dict) -> dict:
        """A bucket of at least ``n_chan`` channels: its channel ranges out
        to the chan devices in one transfer, the single-device bucket step
        on each, the outputs and new state back in one."""
        bk = f"g{g.index}/b{bi}"
        parts = self._chan_parts.get(bk)
        if parts is None:
            return super()._bucket_step(g, bi, bs, z, outputs, state)
        srcs, devs, sub_trees = [], [], []
        for lo, hi, _, part in parts:
            sub_bs = _map_states(
                lambda key, v: v[0].narrow(_chan_dim(key), lo, hi - lo), [bs], bk + "/"
            )
            sub_trees.append(sub_bs)
            leaves = [v for _, v in flatten(sub_bs)] + [z[0], z[1]]
            srcs += leaves
            devs += [part.device] * len(leaves)
        moved = iter(self._move(srcs, devs))
        results = []
        for (_, _, sub, part), sub_bs in zip(parts, sub_trees):
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
        new_parts, pcm = [], []
        for new, outs in results:
            new_parts.append(_refill(new, home))
            outs = {k: next(home) for k in outs}
            pcm.append(outs.pop(f"pcm/{bk}"))
            outputs.update(outs)
        outputs[f"pcm/{bk}"] = torch.cat(pcm)
        return _map_states(
            lambda key, vs: torch.cat(vs, dim=_chan_dim(key)), new_parts, bk + "/",
        )
