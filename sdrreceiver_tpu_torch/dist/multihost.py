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
time shards of its own devices' rows; the halos at a process boundary, the
DC totals, the last shard's tail and the group outputs cross between the
processes of a time group, and where a time row spans processes each
computes only its own channel ranges of a split bucket and the others
cross between the processes of its channel group (:class:`ProcessSpan`),
so every process holds the whole state and every output.  Egress stays per
process: :func:`egress_owner` gives each group's topics to one process.

Transport: the process group is gloo (TCP on the host network, the JAX
package's DCN).  A global mesh's exchanges take one of two transports, a
topology fact every process derives alike from the gathered devices
(:func:`exchange_backend`): where no physical card is held by two processes
they are NCCL collectives on the card tensors themselves (the JAX package's
device collectives inside its compiled step), captured inside the phase
graphs (``dist.meshgraph``); otherwise (two processes on one card, which
NCCL refuses, or CPU shards) gloo calls on pinned host buffers made once
per exchange, the payloads KB-scale halos and the per-block output gather.
:func:`initialize` joins the process group for both partitions.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import faulthandler
import gc
import os
import sys
import threading
import time

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
    "exchange_backend",
    "await_events",
    "ProcessSpan",
    "egress_owner",
    "global_report",
    "output_key_owner",
    "key_owner",
]

#: Seconds a collective waits for its peers before it fails.
TIMEOUT_S = 300

#: Seconds a process whose replay missed :data:`TIMEOUT_S` runs on before
#: it ends itself (exit code 1)
END_GRACE_S = 20

#: Seconds :func:`shutdown` waits for the process group's teardown
SHUTDOWN_S = 30

#: The groups of the exchanges, made once per process group: (backend,
#: ranks) -> group
_groups: dict[tuple[str, tuple[int, ...]], object] = {}


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
    """Leave the process group, if this process joined one.  With an NCCL
    group, the receivers dropped by then are collected first: a CUDA graph
    that captured NCCL collectives holds its communicator, whose teardown
    waits until the graph is gone (on the card, destroying the group with
    live graphs never returned).  The teardown then runs on a thread of its
    own, waited for at most :data:`SHUTDOWN_S`; past that it is left to the
    process's end, with a word on stderr."""
    dist = _dist()
    nccl = any(backend == "nccl" for backend, _ in _groups)
    _groups.clear()
    if not dist.is_initialized():
        return
    if not nccl:
        dist.destroy_process_group()
        return
    gc.collect()
    done = threading.Thread(target=dist.destroy_process_group, daemon=True)
    done.start()
    done.join(SHUTDOWN_S)
    if done.is_alive():
        print(f"multihost: the process group's teardown did not end within {SHUTDOWN_S} s "
              f"(an NCCL communicator still held by a CUDA graph); left to the process's end",
              file=sys.stderr, flush=True)


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


def card_id(device) -> str | None:
    """The physical identity of ``device``: a card's UUID (the same card has
    the same one in every process, whatever index it has there), None for
    the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    index = device.index if device.index is not None else torch.cuda.current_device()
    return str(torch.cuda.get_device_properties(index).uuid)


def global_mesh(n_chan: int = 1, devices=None):
    """One ``(time, chan)`` mesh over EVERY process's devices, laid out as
    the JAX package's: process order, rows of ``n_chan`` consecutive
    devices; with N processes of D local devices, time = N*D/n_chan.  Each
    process passes its own ``devices`` (default: its cards); every process
    needs the same count.  Process p holds the positions ``[p*D, (p+1)*D)``:
    whole time rows where D is a multiple of ``n_chan``, a run of columns of
    one row where D divides it, else a run that ends one row and begins the
    next (2x3 over three processes of two: rows ``p0 p0 p1`` and ``p1 p2
    p2``).  :class:`~.mesh.Mesh` derives from that who publishes each time
    shard and who computes each channel range.  Each device's physical
    identity (:func:`card_id`) is gathered with it, for
    :func:`exchange_backend`."""
    from .mesh import Mesh, local_devices

    devices = [torch.device(d) for d in (devices if devices is not None else local_devices())]
    pid, n = initialize()
    mine = [(str(d), card_id(d)) for d in devices]
    per_proc = [mine]
    if n > 1:
        per_proc = [None] * n
        _dist().all_gather_object(per_proc, mine)
    total = sum(len(p) for p in per_proc)
    if total % n_chan:
        raise ValueError(f"{total} global devices not divisible by n_chan={n_chan}")
    if len({len(p) for p in per_proc}) != 1:
        raise ValueError(
            f"every process needs the same number of devices: {[len(p) for p in per_proc]}")
    flat = [(r, d) for r, p in enumerate(per_proc) for d in p]
    rows = [flat[i:i + n_chan] for i in range(0, total, n_chan)]
    return Mesh([[d for _, (d, _) in row] for row in rows], [[r for r, _ in row] for row in rows],
                rank=pid, ids=[[c for _, (_, c) in row] for row in rows])


def exchange_backend(ids_by_process: list[list[str | None]]) -> str:
    """The transport of a global mesh's exchanges, from each process's
    physical devices (:func:`card_id`, in process order): ``"nccl"`` where
    every device is a card and no card is held by two processes (NCCL binds
    one card to one rank), else ``"gloo"`` (the host buffers).  A topology
    fact: every process computes the same answer from the same list."""
    owners: dict[str, set[int]] = {}
    for rank, ids in enumerate(ids_by_process):
        for c in ids:
            if c is None:
                return "gloo"
            owners.setdefault(c, set()).add(rank)
    return "nccl" if all(len(o) == 1 for o in owners.values()) else "gloo"


def await_events(events, seconds: float) -> bool:
    """Wait on the host until every CUDA event of ``events`` has completed
    or ``seconds`` have passed; whether they all completed."""
    deadline = time.monotonic() + seconds
    for ev in events:
        while not ev.query():
            if time.monotonic() > deadline:
                return False
            time.sleep(0)
    return True


def _abort(group) -> None:
    """Abort the NCCL group: its communicators end."""
    group._get_backend(torch.device("cuda")).abort()


def _give_up(group) -> None:
    """A replay's NCCL kernel waits for a peer that is gone, and nothing
    makes it return: on the card, torch's abort of the group did not return
    while such a kernel waited, and every later sync on the card would wait
    for it.  So abort the group on a thread of its own, and end this
    process with exit code 1 after :data:`END_GRACE_S` whatever catches the
    error or hangs in teardown (faulthandler's native watchdog, which dumps
    every thread's stack first), as torch's NCCL watchdog ends a process
    whose collective timed out."""
    threading.Thread(target=_abort, args=(group,), daemon=True).start()
    faulthandler.dump_traceback_later(END_GRACE_S, exit=True)


def _exchange_groups(parts: list[list[int]], backend: str, world: list[int]) -> dict:
    """The groups of one axis's exchanges (``parts``: the processes of each
    time or channel group, :meth:`~.mesh.Mesh.partition`), made once per
    process group: ranks tuple -> group.  ``torch.distributed.new_group``
    must be called by every process for every group in one order, so each
    process makes all of them, those it is not in too.  A group of one
    process exchanges nothing and gets none; a gloo group of every process
    is the default group (None); NCCL gets groups of its own, the world's
    too."""
    out = {}
    for ranks in parts:
        key = (backend, tuple(ranks))
        if len(ranks) < 2 or (backend == "gloo" and sorted(ranks) == world):
            out[key[1]] = None
            continue
        if key not in _groups:
            _groups[key] = _dist().new_group(
                ranks=None if sorted(ranks) == world else list(ranks), backend=backend,
                timeout=datetime.timedelta(seconds=TIMEOUT_S))
        out[key[1]] = _groups[key]
    return out


def _slots(owners: list[int], group: list[int]) -> tuple[int, list[int]]:
    """An all-gather's layout where item ``k`` is contributed by process
    ``owners[k]`` of ``group``, each process its items in order, zero-padded
    to the most any contributes: ``(pad, slots)``, ``slots[k]`` the row of
    the gathered ``[len(group) * pad, ...]`` that holds item ``k``."""
    pad = max(owners.count(q) for q in group)
    seen = dict.fromkeys(group, 0)
    slots = []
    for q in owners:
        slots.append(group.index(q) * pad + seen[q])
        seen[q] += 1
    return pad, slots


class ProcessSpan:
    """The time shards ``[lo, hi)`` of ``n`` that this process computes in a
    mesh spanning processes, and the exchanges that cross its boundaries.

    Two groups of processes exchange (:class:`~.mesh.Mesh`): this process's
    **column**, its time group (every process where each owns whole rows,
    its column where each owns columns of one row, every process where a
    process's devices end one row and begin the next), and its **row**, its
    channel group, which splits the channel ranges (only itself where it
    owns whole rows).  :attr:`time` says whether the column holds another
    process: where it does not, this process computes every time shard and
    the time exchanges are not made.

    Every exchange goes through :attr:`exchange`, ``exchange(kind, v,
    device)``.  Among the column, each time shard has one publisher
    (:meth:`~.mesh.Mesh.publishers`): ``"halo"`` sends ``v`` (the tail of
    this process's shard :attr:`halo_k`) to the processes :attr:`to` whose
    first shard follows it and gives the tail ``prev`` sent (zeros on the
    processes of global shard 0); ``"last"`` gives the ``v`` of the process
    that publishes the last shard; ``"gather"`` every process's ``v [pad,
    ...]`` (its :attr:`published` shards' values, zero-padded to
    :attr:`pad`) concatenated in rank order, whose rows :attr:`slots` are
    the shards in time order.  Among the row: ``"chan"`` every process's
    ``v [chan_pad, ...]`` (its ranges' rows, zero-padded) concatenated in
    rank order, whose rows :attr:`chan_slots` are the ranges in column
    order.  Where every process holds whole rows or one row's columns the
    padding is none and the slots are in order.  The result lies on
    ``device``.  The default, :meth:`eager`, runs eagerly;
    ``dist.meshgraph`` swaps in one that runs the exchanges inside the CUDA
    graphs of a step, or between them.  Both move the data through buffers
    made once (:meth:`buffers`) and run the call of the exchange on them
    (:meth:`communicate`).

    ``transport``: ``"collective"`` (the default where
    :func:`exchange_backend` gives NCCL) runs the collectives on buffers on
    the home card, the one card the NCCL groups bind in each process (with
    two cards a process, the other card's data reaches it through the
    process's own transfers: one communicator a group and process,
    whichever of its cards a shard is on); on CPU tensors the same calls
    run on gloo, as the CPU tests run them.  ``"staged"`` (the default
    otherwise) runs gloo on pinned host buffers.  :attr:`backend` names the
    library that moves the data; :attr:`group` and :attr:`row_group` are
    the groups of the column's and the row's exchanges (None: the default
    group of every process, or no group where the column or row is this
    process alone).  Nothing falls back: a failed NCCL call, or a group
    that cannot form, raises.

    Every process makes the same exchanges in the same order: gloo pairs
    them by order on the host, NCCL by launch order on the card.  A peer
    that is gone makes a gloo call raise, at the latest after
    :data:`TIMEOUT_S`; an NCCL kernel inside a replayed graph would wait
    for it forever, so a replay ends with :meth:`wait`."""

    def __init__(self, mesh, transport: str | None = None):
        from .mesh import CHAN_AXIS, TIME_AXIS

        rows = mesh.rows()
        self.lo, self.hi, self.n = rows[0], rows[-1] + 1, mesh.shape["time"]
        self.rank = mesh.rank
        ranks = sorted({r for row in mesh.ranks for r in row})
        self.column, self.row = mesh.column_ranks(), mesh.row_ranks()
        self.world = len(self.column)
        self.time = self.world > 1
        self.home = mesh.home
        # the time tables: who publishes each shard, where it lands in a gather
        pubs = mesh.publishers()
        self.published = [i - self.lo for i in range(self.lo, self.hi) if pubs[i] == self.rank]
        self.pad, self.slots = _slots(pubs, self.column)
        self.prev = pubs[self.lo - 1] if self.lo > 0 else None
        self.last = pubs[-1]
        firsts = {q: mesh.rows(q)[0] for q in self.column}
        self.to = [q for q in self.column if firsts[q] > 0 and pubs[firsts[q] - 1] == self.rank]
        (sent,) = {firsts[q] - 1 for q in self.to} or {self.hi - 1}
        self.halo_k = sent - self.lo
        # the channel tables: where each range lands in a "chan" exchange
        self.chan_pad, self.chan_slots = _slots([q for q, _ in mesh.chan_owners()], self.row)
        if transport is None:
            ids = [[c for row, rr in zip(mesh.ids, mesh.ranks) for c, q in zip(row, rr) if q == r]
                   for r in ranks]
            transport = "collective" if exchange_backend(ids) == "nccl" else "staged"
        if transport not in ("collective", "staged"):
            raise ValueError(f"unknown transport {transport!r}")
        self.transport = transport
        self.backend = "nccl" if transport == "collective" and self.home.type == "cuda" else "gloo"
        # every process makes every group of both axes, in one order
        groups = {TIME_AXIS: None, CHAN_AXIS: None}
        for axis in groups:
            made = _exchange_groups(mesh.partition(axis), self.backend, ranks)
            groups[axis] = made[tuple(self.column if axis == TIME_AXIS else self.row)]
        self.group, self.row_group = groups[TIME_AXIS], groups[CHAN_AXIS]
        self.exchange = self.eager
        self._bufs: dict[tuple, tuple[torch.Tensor, torch.Tensor]] = {}

    @property
    def next(self) -> int | None:
        """The first process of :attr:`to` (None where it sends no halo)."""
        return self.to[0] if self.to else None

    def buffers(self, kind: str, v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """``(send, recv)`` for an exchange of ``v``: on the home card for
        the collectives, else on the host (pinned where ``v`` is on a card);
        one buffer for ``"last"``, a broadcast in place.  ``recv`` starts as
        zeros: the halo global shard 0 gets."""
        where = ({"device": self.home} if self.transport == "collective"
                 else {"pin_memory": v.is_cuda})
        send = torch.empty(v.shape, dtype=v.dtype, **where)
        if kind == "last":
            return send, send
        n = {"gather": self.world, "chan": len(self.row)}.get(kind, 1)
        return send, torch.zeros((n * v.shape[0], *v.shape[1:]), dtype=v.dtype, **where)

    def communicate(self, kind: str, send: torch.Tensor, recv: torch.Tensor) -> None:
        """The call of one exchange, from ``send`` into ``recv``: gloo on
        the host buffers, or the collective (:meth:`collective`)."""
        if self.transport == "collective":
            self.collective(kind, send, recv)
            return
        dist = _dist()
        g = self.group
        if kind == "halo":
            reqs = [dist.isend(send, q, group=g) for q in self.to]
            if self.prev is not None:
                reqs.append(dist.irecv(recv, self.prev, group=g))
            for r in reqs:
                r.wait()
        elif kind == "last":
            dist.broadcast(send, self.last, group=g)
        elif kind == "gather":
            dist.all_gather(list(recv.chunk(self.world)), send, group=g)
        elif kind == "chan":
            dist.all_gather(list(recv.chunk(len(self.row))), send, group=self.row_group)
        else:
            raise ValueError(f"unknown exchange {kind!r}")

    def collective(self, kind: str, send: torch.Tensor, recv: torch.Tensor) -> None:
        """The collective of one exchange on the buffers themselves: the
        halo the sends to :attr:`to` and a receive from ``prev`` in one
        batch (none where this process has neither), ``"last"`` a broadcast from the last shard's publisher,
        ``"gather"`` (the column) and ``"chan"`` (the row) an all-gather
        into one tensor.  On the card each is enqueued on the current
        stream's order (inside a capture, into its graph) and the host does
        not wait."""
        dist = _dist()
        g = self.group
        with torch.cuda.device(send.device) if send.is_cuda else contextlib.nullcontext():
            if kind == "halo":
                ops = [dist.P2POp(dist.isend, send, q, g) for q in self.to]
                if self.prev is not None:
                    ops.append(dist.P2POp(dist.irecv, recv, self.prev, g))
                for r in dist.batch_isend_irecv(ops) if ops else ():
                    r.wait()
            elif kind == "last":
                dist.broadcast(send, self.last, group=g)
            elif kind == "gather":
                dist.all_gather_into_tensor(recv, send, group=g)
            elif kind == "chan":
                dist.all_gather_into_tensor(recv, send, group=self.row_group)
            else:
                raise ValueError(f"unknown exchange {kind!r}")

    def eager(self, kind: str, v: torch.Tensor, device) -> torch.Tensor:
        """The eager exchange: ``v`` copied into buffers kept per kind,
        shape and dtype, the call, the result copied to a new tensor on
        ``device``.  Staged, the copies wait for the card, so the host
        buffers are free again when it returns; the collectives keep the
        card's stream order."""
        key = (kind, tuple(v.shape), v.dtype, v.is_cuda)
        if key not in self._bufs:
            self._bufs[key] = self.buffers(kind, v)
        send, recv = self._bufs[key]
        send.copy_(v)
        self.communicate(kind, send, recv)
        return recv.to(device, copy=True)

    def wait(self, events) -> None:
        """Wait on the host for ``events``, the end of a replay whose NCCL
        kernels wait on the peers (torch's watchdog does not see graph
        replays), at most :data:`TIMEOUT_S`.  Past it the group is given up
        (:func:`_give_up`: aborted, and this process ends :data:`END_GRACE_S`
        later) and this raises."""
        if await_events(events, TIMEOUT_S):
            return
        msg = (f"a replay's NCCL exchanges did not finish within {TIMEOUT_S} s: a peer of "
               f"process {self.rank} is gone; the NCCL group was aborted and the process "
               f"ends in {END_GRACE_S} s")
        print(msg, file=sys.stderr, flush=True)
        # one group serves both axes where both are every process
        for g in {id(g): g for g in (self.group, self.row_group) if g is not None}.values():
            _give_up(g)
        raise RuntimeError(msg)


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
