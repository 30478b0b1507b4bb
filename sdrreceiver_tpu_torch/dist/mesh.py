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
        rows = self.rows()
        if not rows or rows != list(range(rows[0], rows[-1] + 1)):
            raise ValueError(f"process {rank} must own a contiguous run of time rows")
        if any(self.ranks[i][j] != rank for i in rows for j in range(n_chan)):
            raise ValueError("a time row must belong to one process")

    def rows(self) -> list[int]:
        """The time shards this process computes."""
        return [i for i, r in enumerate(self.ranks) if r[0] == self.rank]

    def local(self) -> list[torch.device]:
        """The distinct devices of this process's shards in mesh order, the
        home device first: a card that holds several shards is listed once
        (``dist.meshgraph`` captures one graph per phase and card)."""
        return list(dict.fromkeys(d for i in self.rows() for d in self.devices[i]))

    @property
    def home(self) -> torch.device:
        """The device that holds this process's state and outputs: that of
        its first time shard, channel range 0."""
        return self.devices[self.rows()[0]][0]

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
