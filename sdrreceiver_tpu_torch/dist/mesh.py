"""Device meshes for the sharded receiver (port of ``sdrreceiver_tpu.dist.mesh``).

Axes:
  ``time``  time shards of the full-rate wideband front end (ingest, DC
            removal, main-VFO mix + cascade), where the samples/second are
  ``chan``  channel ranges of the per-bucket sub-VFO pipelines

A :class:`Mesh` is a ``(time, chan)`` grid of torch devices.  A list may
repeat a device: ``[cuda:0] * 4`` is a 4x1 mesh on one card, and
``["cpu"] * 8`` eight CPU "devices", as the JAX package's tests use eight
virtual CPU devices.  Inside one process the collectives between shards are
tensor copies between their devices; a mesh whose devices belong to several
processes (``dist.multihost.global_mesh``) records each entry's owning
process and physical identity, and the shards of other processes are
computed there.

Across processes each process's devices are one contiguous run of the
grid's positions in mesh order (rows of ``n_chan``), as the JAX package's
``global_mesh`` lays them out: whole time rows, a run of columns of one
row, or a run that ends one row and begins the next.  A process computes
the time shards of every row it holds a device in.  The processes linked
by a shared column form its **time group** (:meth:`Mesh.column_ranks`),
whose exchanges carry the time halos and gathers, each shard published by
one of them (:meth:`Mesh.publishers`); those linked by a shared row form
its **channel group** (:meth:`Mesh.row_ranks`), which splits each bucket's
channel ranges, each computed by one of them (:meth:`Mesh.chan_owners`).
Every process derives the same tables from ``ranks`` alone.
"""

from __future__ import annotations

import math

import torch

__all__ = ["TIME_AXIS", "CHAN_AXIS", "Mesh", "make_mesh", "local_devices"]

TIME_AXIS = "time"
CHAN_AXIS = "chan"


class Mesh:
    """A ``(time, chan)`` grid of devices.  ``devices[i][j]`` is the device
    of time shard ``i``, channel range ``j``; ``ranks[i][j]`` the process
    that owns it (all 0 in one process); ``rank`` this process; ``ids[i][j]``
    the physical device (a card's UUID; None for the CPU, or where not
    known): ``"cuda:0"`` names another card in each process that sees its
    own cards."""

    def __init__(self, devices, ranks=None, rank: int = 0, ids=None):
        self.devices = [[torch.device(d) for d in row] for row in devices]
        n_time, n_chan = len(self.devices), len(self.devices[0])
        if any(len(row) != n_chan for row in self.devices):
            raise ValueError("mesh rows must have one length")
        self.ranks = (
            [list(r) for r in ranks] if ranks is not None
            else [[rank] * n_chan for _ in range(n_time)]
        )
        self.rank = rank
        self.ids = ([list(r) for r in ids] if ids is not None
                    else [[None] * n_chan for _ in range(n_time)])
        self.shape = {TIME_AXIS: n_time, CHAN_AXIS: n_chan}
        for r in sorted({q for row in self.ranks for q in row} | {rank}):
            self._check_run(r)

    def _cells(self, rank: int) -> tuple[list[int], list[int]]:
        """The rows and the columns that hold a device of process ``rank``."""
        rows = [i for i, row in enumerate(self.ranks) if rank in row]
        cols = sorted({j for row in self.ranks for j, q in enumerate(row) if q == rank})
        return rows, cols

    def _check_run(self, rank: int) -> None:
        n_chan = self.shape[CHAN_AXIS]
        flat = [i * n_chan + j for i, row in enumerate(self.ranks)
                for j, q in enumerate(row) if q == rank]
        if not flat or flat != list(range(flat[0], flat[0] + len(flat))):
            raise ValueError(
                f"process {rank}'s devices must be one contiguous run of the mesh's positions "
                f"(rows of n_chan={n_chan} in process order, as global_mesh lays them out)")

    def rows(self, rank: int | None = None) -> list[int]:
        """The time shards process ``rank`` (default: this one) computes:
        every row it holds a device in."""
        return self._cells(self.rank if rank is None else rank)[0]

    def columns(self) -> list[int]:
        """The chan positions of this process's devices, over all its rows
        (:meth:`own` gives them row by row)."""
        return self._cells(self.rank)[1]

    def column_ranks(self, rank: int | None = None) -> list[int]:
        """The processes of ``rank``'s time group (default: this process's),
        in rank order: those linked to it by a shared column, whose rows
        together are every row of the mesh.  Where each process holds whole
        rows it is every process; where each holds a run of columns of one
        row, its column; where a process's devices end one row and begin
        the next, every process."""
        rank = self.rank if rank is None else rank
        return next(g for g in self.partition(TIME_AXIS) if rank in g)

    def row_ranks(self, rank: int | None = None) -> list[int]:
        """The processes of ``rank``'s channel group (default: this
        process's), in rank order: those linked to it by a shared time row,
        which split each bucket's channel ranges between them (only itself
        where it holds whole rows)."""
        rank = self.rank if rank is None else rank
        return next(g for g in self.partition(CHAN_AXIS) if rank in g)

    def partition(self, axis: str) -> list[list[int]]:
        """Every time group (``TIME_AXIS``: the processes linked by sharing
        a column, directly or through others; the groups of the time
        exchanges) or channel group (``CHAN_AXIS``: linked by sharing a
        row; the groups of the channel exchange), each sorted, in order of
        their first process: the same list in every process."""
        if axis == TIME_AXIS:
            sets = [{row[j] for row in self.ranks} for j in range(self.shape[CHAN_AXIS])]
        else:
            sets = [set(row) for row in self.ranks]
        groups: list[set] = []
        for s in sets:
            groups = [g for g in groups if not g & s] + [s.union(*(g for g in groups if g & s))]
        return sorted(sorted(g) for g in groups)

    def publishers(self, rank: int | None = None) -> list[int]:
        """Per time row, the process of ``rank``'s time group that publishes
        that time shard to the group's exchanges: the last of the row's
        processes in the group.  So a process ending one row whose next row
        begins with others sends them the halo of that row, and never the
        halos of two rows."""
        group = set(self.column_ranks(rank))
        return [[q for q in row if q in group][-1] for row in self.ranks]

    def chan_owners(self, rank: int | None = None) -> list[tuple[int, int]]:
        """Per chan position ``j`` (a split bucket's ``j``-th channel range),
        the process of ``rank``'s channel group that computes it and the
        time row of its device there.  A process of ``D`` devices computes
        the ranges of its first ``gcd(n_chan, D)`` devices in mesh order:
        alone in its group (whole rows), every range on its first row's
        devices; in a row that spans processes, its own positions; where
        its devices end one row and begin the next, ranges that the
        group's other processes do not hold first, so every range is
        computed once in the group.  Raises where that cover fails (no
        ``global_mesh`` layout)."""
        group = self.row_ranks(rank)
        n_chan = self.shape[CHAN_AXIS]
        owners: dict[int, list[tuple[int, int]]] = {}
        for q in group:
            cells = [(i, j) for i, row in enumerate(self.ranks) for j, p in enumerate(row)
                     if p == q]
            for i, j in cells[:math.gcd(n_chan, len(cells))]:
                owners.setdefault(j, []).append((q, i))
        if sorted(owners) != list(range(n_chan)) or any(len(o) > 1 for o in owners.values()):
            raise ValueError(f"the channel ranges of processes {group} do not cover each chan "
                             f"position once")
        return [owners[j][0] for j in range(n_chan)]

    def own(self, i: int) -> list[tuple[int, torch.device]]:
        """This process's devices in time row ``i``, each with its chan
        position."""
        return [(j, d) for j, (d, q) in enumerate(zip(self.devices[i], self.ranks[i]))
                if q == self.rank]

    def local(self) -> list[torch.device]:
        """The distinct devices of this process's shards in mesh order, the
        home device first: a card that holds several shards is listed once
        (``dist.meshgraph`` captures one graph per phase and card)."""
        return list(dict.fromkeys(d for i in self.rows() for _, d in self.own(i)))

    @property
    def home(self) -> torch.device:
        """The device that holds this process's state and outputs: its own
        first device (first time row, first of its chan positions)."""
        return self.own(self.rows()[0])[0][1]

    @property
    def multiprocess(self) -> bool:
        return any(r != self.rank for row in self.ranks for r in row)


def _default_devices() -> list[torch.device]:
    """Every local card; never the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass devices= (e.g. ['cpu'] * n) for a CPU mesh"
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def local_devices(n: int | None = None, device: torch.device | str = "cuda") -> list[torch.device]:
    """``n`` devices of this process of ``device``'s type: the local cards in
    order, repeated when ``n`` exceeds their count (``cuda:N``: that card
    ``n`` times), or the CPU ``n`` times.  ``n=None``: every local card, or
    one CPU."""
    device = torch.device(device)
    if device.type == "cpu":
        return [device] * (n or 1)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    cards = _default_devices() if device.index is None else [device]
    n = len(cards) if n is None else n
    return [cards[i % len(cards)] for i in range(n)]


def make_mesh(n_time: int | None = None, n_chan: int | None = None, devices=None) -> Mesh:
    """Build a ``(time, chan)`` mesh.

    Defaults: every local card on the ``time`` axis (the front end is where
    the samples/second are).  ``n_time * n_chan`` must equal the number of
    devices given."""
    devices = list(devices if devices is not None else _default_devices())
    n = len(devices)
    if n_time is None and n_chan is None:
        n_time, n_chan = n, 1
    elif n_time is None:
        n_time = n // n_chan
    elif n_chan is None:
        n_chan = n // n_time
    if n_time * n_chan != n:
        raise ValueError(f"{n_time}x{n_chan} mesh != {n} devices")
    return Mesh([devices[i * n_chan:(i + 1) * n_chan] for i in range(n_time)])
