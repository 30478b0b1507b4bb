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

Across processes each process's devices form one rectangle of the grid:
whole time rows, or one run of columns of one row (a time row that spans
processes, as the JAX package's ``global_mesh`` lays one out when a process
holds fewer devices than ``n_chan``).  A process computes the time shards
of every row it holds a device in; the processes of its **column**
(:meth:`Mesh.column_ranks`, its time neighbours) exchange the time halos and
gathers, and those of its **row** (:meth:`Mesh.row_ranks`) the channel
ranges of the split buckets.
"""

from __future__ import annotations

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
            self._check_rectangle(r)

    def _cells(self, rank: int) -> tuple[list[int], list[int]]:
        """The rows and the columns that hold a device of process ``rank``."""
        rows = [i for i, row in enumerate(self.ranks) if rank in row]
        cols = sorted({j for row in self.ranks for j, q in enumerate(row) if q == rank})
        return rows, cols

    def _check_rectangle(self, rank: int) -> None:
        rows, cols = self._cells(rank)
        if not rows or rows != list(range(rows[0], rows[-1] + 1)):
            raise ValueError(f"process {rank} must own a contiguous run of time rows")
        n_cells = sum(q == rank for row in self.ranks for q in row)
        if n_cells != len(rows) * len(cols) or (
                len(rows) > 1 and len(cols) != self.shape[CHAN_AXIS]):
            raise ValueError(
                f"process {rank}'s devices must cover whole time rows or one run of columns "
                f"of one row (a process's device count a multiple or a divisor of n_chan="
                f"{self.shape[CHAN_AXIS]})")

    def rows(self) -> list[int]:
        """The time shards this process computes: every row it holds a
        device in."""
        return self._cells(self.rank)[0]

    def columns(self) -> list[int]:
        """The chan positions of this process's devices (the same in each of
        its rows)."""
        return self._cells(self.rank)[1]

    def column_ranks(self, rank: int | None = None) -> list[int]:
        """The processes of ``rank``'s column (default: this process's), in
        time order: its time neighbours, whose rows together are the mesh's
        rows, each once."""
        rank = self.rank if rank is None else rank
        j = self._cells(rank)[1][0]
        return list(dict.fromkeys(row[j] for row in self.ranks))

    def row_ranks(self, rank: int | None = None) -> list[int]:
        """The processes of ``rank``'s time row (default: this process's),
        in column order: those that split a bucket's channels with it."""
        rank = self.rank if rank is None else rank
        return list(dict.fromkeys(self.ranks[self._cells(rank)[0][0]]))

    def partition(self, axis: str) -> list[list[int]]:
        """Every process's column (``TIME_AXIS``: the groups of the time
        exchanges) or row (``CHAN_AXIS``: the groups of the channel
        exchange), each once, in order of their first process: the same
        list in every process."""
        ranks = sorted({q for row in self.ranks for q in row})
        of = self.column_ranks if axis == TIME_AXIS else self.row_ranks
        return [list(g) for g in dict.fromkeys(tuple(of(r)) for r in ranks)]

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
