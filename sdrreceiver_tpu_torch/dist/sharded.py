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
unsharded receivers of either package.  The sharded step runs eagerly, not
as a CUDA graph (``cuda_graphs=False``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..graph.compiler import CompiledReceiver, _is_planar_pair
from ..graph.plan import ReceiverPlan
from ..kernels import ingest
from . import halo
from .mesh import CHAN_AXIS, TIME_AXIS, Mesh, local_devices, make_mesh

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
    divisor times ``n_time``."""

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
        if mesh.multiprocess:
            from .multihost import ProcessSpan

            self._span = ProcessSpan(mesh)
        if kwargs.pop("cuda_graphs", False):
            raise ValueError("ShardedReceiver runs eagerly: cuda_graphs=True is not supported")
        # eager: a step copies between devices and, across processes, waits on gloo
        super().__init__(plan, block, device=mesh.home, cuda_graphs=False, **kwargs)
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

    # ------------------------------------------------------- time shards
    def _shard_devices(self) -> list[tuple[int, torch.device]]:
        return [(i, self.mesh.devices[i][0]) for i in self._rows]

    def _ingest(self, state: dict, raw: torch.Tensor):
        """This process's time shards of ``raw`` on their devices, planar,
        with DC removed by the halo composition."""
        t_local = self.block // self.n_time
        xs = []
        for i, dev in self._shard_devices():
            r = raw[2 * i * t_local:2 * (i + 1) * t_local].to(dev)
            xs.append(ingest.u8_iq_to_planar(r) if r.dtype == torch.uint8
                      else ingest.f32_pairs_to_planar(r))
        if not self.plan.dc_correct:
            return state["dc"], xs
        return halo.timeshard_dc_local(state["dc"], xs, span=self._span)

    def _input_tail(self, xs, n: int | None) -> torch.Tensor:
        t_local = self.block // self.n_time
        w = min(n, t_local) if n else t_local
        k = min(-(-n // t_local), self.n_time) if n else self.n_time
        tails = halo.gather([torch.stack((xr[-w:], xi[-w:])) for xr, xi in xs],
                            self.device, self._span)
        return torch.cat(tails[-k:], dim=-1)[:, -n:] if n else torch.cat(tails, dim=-1)

    def _left_halos(self, state: dict, xs, p: int) -> list[torch.Tensor]:
        """The left neighbour's last ``p`` inputs; global shard 0's from the
        carried xtail."""
        lefts = halo.right_halo([torch.stack((xr[-p:], xi[-p:])) for xr, xi in xs], p, self._span)
        if self._rows[0] == 0:
            lefts[0] = state["xtail"][:, -p:].to(lefts[0].device)
        return lefts

    def _gather_time(self, parts) -> tuple[torch.Tensor, torch.Tensor]:
        """Per-shard planar ``[C, t]`` pairs -> the whole block on the home
        device."""
        z = torch.cat(halo.gather([torch.stack(p) for p in parts], self.device, self._span), dim=-1)
        return z[0], z[1]

    def _stateful_group(self, gs: dict, xs):
        t_local = self.block // self.n_time
        nco_state, zs = halo.timeshard_mix_local(gs["nco"], xs, self.plan.fs, t_local, self._span)
        hists, zs = halo.timeshard_cascade_local(gs["cascade"], zs, self._hb1, self._span)
        return nco_state, hists, zs

    # ------------------------------------------------------ chan ranges
    def _bucket_step(self, g, bi: int, bs: dict, z, outputs: dict, state: dict) -> dict:
        bk = f"g{g.index}/b{bi}"
        parts = self._chan_parts.get(bk)
        if parts is None:
            return super()._bucket_step(g, bi, bs, z, outputs, state)
        new_parts, pcm = [], []
        for lo, hi, sub, part in parts:
            sub_g = dataclasses.replace(
                g, buckets=tuple(sub if k == bi else b for k, b in enumerate(g.buckets))
            )
            sub_bs = _map_states(
                lambda key, v: v[0].narrow(_chan_dim(key), lo, hi - lo).to(part.device),
                [bs], bk + "/",
            )
            outs: dict = {}
            new_parts.append(part._bucket_step(
                sub_g, bi, sub_bs, (z[0].to(part.device), z[1].to(part.device)), outs, state
            ))
            pcm.append(outs.pop(f"pcm/{bk}").to(self.device))
            outputs.update({k: v.to(self.device) for k, v in outs.items()})
        outputs[f"pcm/{bk}"] = torch.cat(pcm)
        return _map_states(
            lambda key, vs: torch.cat([v.to(self.device) for v in vs], dim=_chan_dim(key)),
            new_parts, bk + "/",
        )
