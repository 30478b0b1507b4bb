"""Multi-process deployment: two partitions (port of
``sdrreceiver_tpu.dist.multihost``).

**groups**: each process owns WHOLE main-VFO groups (front end and all its
buckets) and runs them on its own devices; nothing per sample crosses
processes.  Its ceiling is the balance of the group costs
(:func:`assignment_report`).

  * :func:`assign_groups` — deterministic balanced assignment of plan
    groups to ``n_hosts`` by front-end + bucket FLOP cost (largest first)
  * :func:`host_subplan` — a ReceiverPlan of one host's groups
  * :func:`assignment_report` — the balance-efficiency ceiling

**global**: every process runs the FULL plan over ONE ``(time, chan)`` mesh
over every process's devices (:func:`global_mesh`).  A process computes the
time shards of its own devices; the halos at a process boundary, the DC
totals, the last shard's tail and the group outputs cross processes
(:class:`ProcessSpan`), so every process holds the whole state and every
output.  Egress stays per process: :func:`egress_owner` gives each group's
topics to one process.

Transport: ``torch.distributed`` over gloo (TCP on the host network, the
JAX package's DCN).  CUDA tensors are staged through pinned host buffers
made once per exchange; the payloads are KB-scale halos and the
per-block output gather.
:func:`initialize` joins the process group for both partitions.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import numpy as np
import torch

from ..graph.plan import ReceiverPlan

__all__ = [
    "initialize",
    "shutdown",
    "distributed_subplan",
    "group_costs",
    "assign_groups",
    "host_subplan",
    "assignment_report",
    "global_mesh",
    "ProcessSpan",
    "egress_owner",
    "global_report",
    "output_key_owner",
    "key_owner",
]

#: Seconds a collective waits for its peers before it fails.
TIMEOUT_S = 300


def _dist():
    import torch.distributed as dist

    return dist


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> tuple[int, int]:
    """Join the gloo process group at ``tcp://coordinator_address`` (a
    no-op without one).  The world size and rank default to the
    ``WORLD_SIZE`` and ``RANK`` environment variables (else 1 and 0).
    Returns ``(process_id, num_processes)``."""
    dist = _dist()
    if coordinator_address is not None and not dist.is_initialized():
        n = num_processes if num_processes is not None else int(os.environ.get("WORLD_SIZE", 1))
        pid = process_id if process_id is not None else int(os.environ.get("RANK", 0))
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coordinator_address}", world_size=n, rank=pid,
            timeout=datetime.timedelta(seconds=TIMEOUT_S),
        )
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    dist = _dist()
    if dist.is_initialized():
        dist.destroy_process_group()


def distributed_subplan(
    plan: ReceiverPlan,
    coordinator_address: str,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> tuple[ReceiverPlan, dict]:
    """groups partition for one process: join the process group, then
    restrict the plan to this process's groups.  Every process computes
    the same deterministic assignment, so nothing but the join crosses
    processes.  Returns ``(subplan, info)``; a process assigned no group
    (more processes than groups) gets an empty plan."""
    pid, n = initialize(coordinator_address, num_processes, process_id)
    assign = assign_groups(plan, n)
    sub = host_subplan(plan, assign, pid)
    info = {
        "process_id": pid,
        "num_processes": n,
        "coordinator": coordinator_address,
        "assignment": {int(k): int(v) for k, v in assign.items()},
        "local_groups": [g.index for g in sub.groups],
        "local_topics": [s.topic for g in sub.groups for b in g.buckets for s in b.subs],
        "balance_efficiency": assignment_report(plan, n)["balance_efficiency"],
    }
    return sub, info


def group_costs(plan: ReceiverPlan) -> dict[int, float]:
    """FLOPs/block of each group (front end + its buckets): a per-group view
    of obs.metrics.group_cost_model, the cost function the roofline report
    sums."""
    from ..obs.metrics import group_cost_model

    return {gidx: c["flops_per_block"] for gidx, c in group_cost_model(plan).items()}


def assign_groups(plan: ReceiverPlan, n_hosts: int) -> dict[int, int]:
    """group index -> host id, greedy largest-first onto the lightest host."""
    if n_hosts < 1:
        raise ValueError("n_hosts must be >= 1")
    loads = [0.0] * n_hosts
    assign: dict[int, int] = {}
    for gidx, cost in sorted(group_costs(plan).items(), key=lambda kv: -kv[1]):
        host = int(np.argmin(loads))
        assign[gidx] = host
        loads[host] += cost
    return assign


def host_subplan(plan: ReceiverPlan, assignment: dict[int, int], host: int) -> ReceiverPlan:
    """The plan restricted to one host's groups (indices preserved)."""
    groups = tuple(g for g in plan.groups if assignment.get(g.index) == host)
    return dataclasses.replace(plan, groups=groups)


def global_mesh(n_chan: int = 1, devices=None):
    """One ``(time, chan)`` mesh over EVERY process's devices, in process
    order: with N processes of D local devices, time = N*D/n_chan.  Each
    process passes its own ``devices`` (default: its cards); every process
    needs the same count, a multiple of ``n_chan``, so that each time row
    lies on one process."""
    from .mesh import Mesh, local_devices

    devices = [torch.device(d) for d in (devices if devices is not None else local_devices())]
    pid, n = initialize()
    per_proc = [[str(d) for d in devices]]
    if n > 1:
        per_proc = [None] * n
        _dist().all_gather_object(per_proc, [str(d) for d in devices])
    total = sum(len(p) for p in per_proc)
    if total % n_chan:
        raise ValueError(f"{total} global devices not divisible by n_chan={n_chan}")
    if len({len(p) for p in per_proc}) != 1 or len(devices) % n_chan:
        raise ValueError(
            f"every process needs the same number of devices, a multiple of n_chan={n_chan}: "
            f"{[len(p) for p in per_proc]}"
        )
    flat = [(r, d) for r, p in enumerate(per_proc) for d in p]
    rows = [flat[i:i + n_chan] for i in range(0, total, n_chan)]
    return Mesh([[d for _, d in row] for row in rows], [[r for r, _ in row] for row in rows],
                rank=pid)


class ProcessSpan:
    """The time shards ``[lo, hi)`` of ``n`` that this process computes in a
    mesh spanning processes, and the exchanges that cross its boundaries.

    Every exchange goes through :attr:`exchange`, ``exchange(kind, v,
    device)``: ``"halo"`` gives the previous process's ``v`` (zeros on the
    process of global shard 0), ``"last"`` the ``v`` of the process that
    owns the last shard, ``"gather"`` every process's ``v [k, ...]``
    concatenated in process order; the result lies on ``device``.  The
    default, :meth:`staged`, runs eagerly; ``dist.meshgraph`` swaps in one
    that makes each exchange a boundary between two phases of CUDA graphs.
    Both move the data through host buffers made once (:meth:`host_buffers`,
    pinned for a card) and run the gloo call on them (:meth:`communicate`).
    Every process makes the same exchanges in the same order: gloo pairs
    them by order.  A peer that is gone makes the call raise, at the latest
    after :data:`TIMEOUT_S`."""

    def __init__(self, mesh):
        rows = mesh.rows()
        self.lo, self.hi, self.n = rows[0], rows[-1] + 1, mesh.shape["time"]
        self.rank = mesh.rank
        self.prev = mesh.ranks[self.lo - 1][0] if self.lo > 0 else None
        self.next = mesh.ranks[self.hi][0] if self.hi < self.n else None
        self.last = mesh.ranks[-1][0]
        self.world = len({r for row in mesh.ranks for r in row})
        self.exchange = self.staged
        self._staging: dict[tuple, tuple[torch.Tensor, torch.Tensor]] = {}

    def host_buffers(self, kind: str, v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """``(send, recv)``: host buffers for an exchange of ``v`` (pinned
        where ``v`` is on a card; one buffer for ``"last"``, a broadcast in
        place).  ``recv`` starts as zeros: the halo global shard 0 gets."""
        pin = v.is_cuda
        send = torch.empty(v.shape, dtype=v.dtype, pin_memory=pin)
        if kind == "last":
            return send, send
        shape = (self.world * v.shape[0], *v.shape[1:]) if kind == "gather" else v.shape
        return send, torch.zeros(shape, dtype=v.dtype, pin_memory=pin)

    def communicate(self, kind: str, send: torch.Tensor, recv: torch.Tensor) -> None:
        """The gloo call of one exchange, from ``send`` into ``recv``."""
        dist = _dist()
        if kind == "halo":
            reqs = []
            if self.next is not None:
                reqs.append(dist.isend(send, self.next))
            if self.prev is not None:
                reqs.append(dist.irecv(recv, self.prev))
            for r in reqs:
                r.wait()
        elif kind == "last":
            dist.broadcast(send, self.last)
        elif kind == "gather":
            dist.all_gather(list(recv.chunk(self.world)), send)
        else:
            raise ValueError(f"unknown exchange {kind!r}")

    def staged(self, kind: str, v: torch.Tensor, device) -> torch.Tensor:
        """The eager exchange: ``v`` copied into host buffers kept per kind,
        shape and dtype, the gloo call, the result copied to a new tensor
        on ``device``.  The copies wait for the card, so the buffers are
        free again when it returns."""
        key = (kind, tuple(v.shape), v.dtype, v.is_cuda)
        if key not in self._staging:
            self._staging[key] = self.host_buffers(kind, v)
        send, recv = self._staging[key]
        send.copy_(v)
        self.communicate(kind, send, recv)
        return recv.to(device, copy=True)


def egress_owner(plan: ReceiverPlan, n_hosts: int) -> dict[int, int]:
    """group index -> host that PUBLISHES its topics in global mode (the
    groups-mode assignment, so consumers see one topic -> host map)."""
    return assign_groups(plan, n_hosts)


def output_key_owner(plan: ReceiverPlan, n_hosts: int) -> dict[str, int]:
    """Step-output key pattern -> owning host (the global-mode egress
    filter).  Entries ending in ``/`` (``pcm/g<i>/``) are PREFIXES; the
    others (``iq/<topic>``) EXACT keys, so ``iq/A`` never captures
    ``iq/AB``."""
    own = egress_owner(plan, n_hosts)
    keys: dict[str, int] = {}
    for g in plan.groups:
        keys[f"pcm/g{g.index}/"] = own[g.index]
        if g.publishes_iq:
            keys[f"iq/{g.zmq_topic}"] = own[g.index]
    return keys


def key_owner(owner_map: dict[str, int], key: str) -> int | None:
    """Owning host of one step-output key under an :func:`output_key_owner`
    map, or None if unowned (taps etc.)."""
    for pat, h in owner_map.items():
        if key.startswith(pat) if pat.endswith("/") else key == pat:
            return h
    return None


def global_report(plan: ReceiverPlan, n_hosts: int, n_time: int) -> dict:
    """Balance and traffic model of global mode: compute splits evenly by
    construction; the wire carries (a) the per-stage halos that cross each
    of the ``n_hosts - 1`` process boundaries and (b) the replicated output
    gather."""
    total = sum(group_costs(plan).values())
    halo_bytes = 0
    for g in plan.groups:
        if g.direct:
            continue
        # a 10-sample complex64 halo per cascade stage per boundary
        halo_bytes += g.stages * 10 * 8 * (n_hosts - 1)
    out_bytes = 0
    tg = plan.block_samples
    for g in plan.groups:
        t_out = tg >> g.stages
        for b in g.buckets:
            out_bytes += 2 * b.channels * ((t_out >> b.stages) // b.late_factor)
        if g.publishes_iq:
            out_bytes += t_out
    return {
        "mode": "global",
        "n_hosts": n_hosts,
        "n_time": n_time,
        "balance_efficiency": 1.0,
        "flops_per_block_per_host": round(total / n_hosts / 1e6, 3),
        "halo_bytes_per_block": halo_bytes,
        "output_gather_bytes_per_block": out_bytes,
        # wire seconds per block at a conservative 5 GB/s host link, over
        # the block's realtime length
        "dcn_fraction_of_block": round(
            (halo_bytes + out_bytes) / 5e9 / (plan.block_samples / plan.fs), 6
        ),
    }


def assignment_report(plan: ReceiverPlan, n_hosts: int) -> dict:
    costs = group_costs(plan)
    assign = assign_groups(plan, n_hosts)
    loads = [0.0] * n_hosts
    for gidx, host in assign.items():
        loads[host] += costs[gidx]
    total = sum(loads)
    peak = max(loads) if loads else 0.0
    # efficiency = achievable speedup / ideal speedup given the partition
    eff = (total / peak / n_hosts) if peak > 0 else 1.0
    return {
        "n_hosts": n_hosts,
        "assignment": {int(k): int(v) for k, v in assign.items()},
        "host_flops_per_block": [round(v / 1e6, 3) for v in loads],
        "balance_efficiency": round(eff, 4),
    }
