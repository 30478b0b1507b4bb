"""CUDA graphs for the step entries of a :class:`~.sharded.ShardedReceiver`:
one graph per phase and card, whether the mesh lives in one process or
spans several.

Counterpart of the JAX package's compiled sharded step, where the front
runs inside ``jax.shard_map`` and each entry is one XLA executable of
per-shard compute with collectives between the pieces.  A CUDA graph
records the work of one card's capturing stream, so a step over several
cards is cut where data crosses devices:

* a **transfer** is one call of ``ShardedReceiver._move`` (one per
  exchange, every shard together: the block out to the shards, the DC
  totals in, the halos, the gathers, a split bucket's channel ranges out
  and back).  It copies into static buffers of its own, made on the body's
  first run and reused by every later run in call order: a peer copy
  between two cards, a copy within one;
* an **exchange** is one call of ``ProcessSpan.exchange`` where the mesh
  spans processes (among the processes of a time group: the halo into
  this process's first shard, the last shard's cascade history, the
  gathers of the DC totals, the input tail and each group's outputs; among
  those of a channel group: each split bucket's channel ranges,
  ``"chan"``).
  Its buffers are made on the body's first run.
  Where the processes hold distinct cards (``ProcessSpan.transport ==
  "collective"``) it is an NCCL collective on static buffers on the home
  card, captured inside the home card's graph of the phase like any other
  op: no boundary.  A source on the process's other card reaches the home
  card through a transfer first (the NCCL group binds one card a process).
  Otherwise (staged: two processes sharing a card) its data goes through
  static pinned host buffers and a static destination on the card: the
  phase before it ends by copying the source into the send buffer, the
  host waits for the cards of its source and its destination and runs the
  gloo call on the host buffers, and the phase after it begins by copying
  the receive buffer to the destination;
* a **phase** is the compute between two transfers or exchanges.  Each
  card that computes in it has one graph holding the work of all its
  shards.

Replaying an entry runs, phase by phase, the graphs of the cards that
compute in it and then the transfer's copies or the staged exchange's host
part.  Each card's stream keeps its own order, and torch's copy between two
cards waits on both cards' streams, so within a process nothing waits on
the host; only a staged exchange does, because gloo reads and writes host
memory.  A collective's NCCL kernels wait on the peer's on the card, so a
replay of an entry with collectives makes no host round trip between its
phases; it ends with the host waiting for every card's stream, bounded by
``multihost.TIMEOUT_S`` (``ProcessSpan.wait``: an NCCL kernel whose peer is
gone would wait forever, and torch's watchdog does not see graph replays).
A mesh on one card (``[cuda:0] * 4``) takes the same path, one graph per
phase, so one card runs the code that four run.

Everything else is :class:`~..graph.cudagraph.StepGraphs`': one set of
graphs per entry (the single step, each burst size k with k steps of
phases), ``WARMUP_STEPS`` runs of the body on side streams against a
throwaway state before the capture (every card's), one memory pool per
card, the state donated (the receiver's buffers on the home device updated
in place), the outputs copied out after the last phase, and each replay
adding to the wrappers' ``launches`` what its capture recorded.  A failed
capture raises; no phase falls back to the eager step.

Across processes the warm-up runs really exchange data, so every process
runs the same entries in the same order, each with its ``WARMUP_STEPS``
warm-up runs, in lockstep (gloo pairs the calls by order on the host, NCCL
by launch order on the card; the receivers of a global mesh step the same
blocks).  The warm-ups also make the NCCL communicators, before any
capture opens.  The capture exchanges nothing: it records the copies into
and out of the host buffers, or the collectives, and no data is real yet.
Each replay then makes every exchange once.  A peer that died makes the
gloo call raise (at the latest after ``multihost.TIMEOUT_S``), or the wait
at the replay's end abort the NCCL group and raise, and the step with it.

Several captures are open at once on one thread (one per card), and one
is ended and instantiated while the others run, so they capture in
``relaxed`` mode: ``thread_local`` forbids such calls during a capture.
Destroying a graph during a capture invalidates it on the card, so the
garbage collector is off while the body runs under capture (a receiver
dropped earlier may hold graphs in a reference cycle) and the empty graphs
of a phase are released only after the last capture ends.

Only the cards the body's first warm-up run touches capture.  While it
captures, a dispatch mode notes which cards each phase touched (a card's
empty graph is dropped) and raises on an op whose tensors lie on two
devices or on a card that is not capturing: outside a transfer such an
op would run once, at capture, and never again.

On the CPU nothing is captured: each call runs the body with its
transfers and exchanges going through the same static buffers; that is
what the CPU tests hold.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import warnings

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from ..graph.cudagraph import WARMUP_STEPS, StepGraphs, _Entry

__all__ = ["MeshGraphs"]


def _copy(dsts: list[torch.Tensor], srcs: list[torch.Tensor]) -> None:
    """``dsts[i].copy_(srcs[i])``: the pairs within one device one foreach
    call per dtype (a fused copy needs one dtype), those between devices
    one by one."""
    groups: dict[tuple, tuple[list, list]] = {}
    for d, s in zip(dsts, srcs):
        if d.device != s.device:
            d.copy_(s, non_blocking=True)
            continue
        ds, ss = groups.setdefault((d.device, d.dtype), ([], []))
        ds.append(d)
        ss.append(s)
    for ds, ss in groups.values():
        torch._foreach_copy_(ds, ss)


def _cards(tensors) -> set[torch.device]:
    return {t.device for t in tensors if isinstance(t, torch.Tensor) and t.is_cuda}


def _card(dev) -> torch.device | None:
    """A device (a mesh's entry, a factory op's argument) as an indexed
    card, or None for another type."""
    dev = torch.device(dev)
    if dev.type != "cuda":
        return None
    return dev if dev.index is not None else torch.device("cuda", torch.cuda.current_device())


class _Cards(TorchDispatchMode):
    """The cards whose tensors a body's ops touch (``seen``)."""

    def __init__(self):
        super().__init__()
        self.seen: set[torch.device] = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.seen |= _cards(tree_leaves((args, kwargs, out)))
        return out


class _Recorder(TorchDispatchMode):
    """The capture of one entry: between two transfers or exchanges every
    card's capture is open; :meth:`boundary` closes them, keeps the graphs
    of the cards that computed, and records what runs between this phase
    and the next (the transfer's copies, the exchange's host part)."""

    def __init__(self, cards: list[torch.device], pools: dict):
        super().__init__()
        self.cards, self.pools = cards, pools
        self.steps: list[tuple[list, object]] = []
        self.open: dict = {}  # card -> its graph, while its capture is open
        self.checking = False  # inside a phase (not inside torch's capture calls)
        self.touched: set[torch.device] = set()
        self.empty: list = []  # dropped graphs, destroyed after the last capture

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not self.checking:
            return func(*args, **kwargs)
        cards = _cards(tree_leaves((args, kwargs)))
        if kwargs.get("device") is not None and _card(kwargs["device"]) is not None:
            cards.add(_card(kwargs["device"]))
        if len(cards) > 1 or not cards <= self.open.keys():
            raise RuntimeError(
                f"{func} on {sorted(map(str, cards))} inside a phase of a mesh step: data "
                f"crosses devices only through ShardedReceiver._move"
            )
        out = func(*args, **kwargs)
        self.touched |= cards | _cards(tree_leaves(out))
        return out

    def open_phase(self) -> None:
        for d in self.cards:
            g = torch.cuda.CUDAGraph()
            with torch.cuda.device(d):
                g.capture_begin(pool=self.pools[d], capture_error_mode="relaxed")
            self.open[d] = g
        self.touched, self.checking = set(), True

    def close_phase(self, after=None) -> None:
        self.checking = False
        kept = []
        for d, g in list(self.open.items()):
            with torch.cuda.device(d), warnings.catch_warnings():
                warnings.simplefilter("ignore")  # an empty graph warns; it is dropped
                g.capture_end()
            del self.open[d]
            (kept if d in self.touched else self.empty).append(g)
        self.steps.append((kept, after))

    def boundary(self, after) -> None:
        self.close_phase(after)
        self.open_phase()

    def abandon(self) -> None:
        """End the captures left open by a failure (their graphs are
        discarded) so the cards' streams leave capture mode; called with
        the capturing streams current."""
        self.checking = False
        for d, g in self.open.items():
            with torch.cuda.device(d), contextlib.suppress(RuntimeError), \
                    warnings.catch_warnings():
                warnings.simplefilter("ignore")
                g.capture_end()
        self.open = {}


class _Exchange:
    """One exchange across processes of an entry's body: its buffers
    (``ProcessSpan.buffers``), made once.  Staged, also its destination on
    ``device``; called, the host's part of it (wait for the cards of its
    source and destination, then the gloo call on the host buffers)."""

    def __init__(self, span, kind: str, v: torch.Tensor, device):
        self.span, self.kind = span, kind
        self.send, self.recv = span.buffers(kind, v)
        self.device = torch.device(device)
        if span.transport == "staged":
            self.dst = torch.empty(self.recv.shape, dtype=v.dtype, device=device)
            self.cards = {d for d in (v.device, self.dst.device) if d.type == "cuda"}

    def fits(self, kind: str, v: torch.Tensor, device) -> bool:
        return (kind == self.kind and v.shape == self.send.shape and v.dtype == self.send.dtype
                and torch.device(device) == self.device)

    def wait(self) -> None:
        """Wait for the cards: the send buffer is written, the receive
        buffer read by the last replay's copy out of it."""
        for d in self.cards:
            torch.cuda.synchronize(d)

    def __call__(self) -> None:
        self.wait()
        self.span.communicate(self.kind, self.send, self.recv)


class _Transfers:
    """The transfers and exchanges of one entry's body, each in call order:
    the k-th transfer of a run copies its tensors into the k-th set of
    static buffers, the k-th exchange goes through the k-th
    :class:`_Exchange` (both made on the first run), so every run moves the
    same data between the same buffers.  While ``recorder`` captures, each
    transfer, and each staged exchange, is a phase boundary: the copies of
    a transfer, and the host part of an exchange, are recorded for the
    replays instead of made.  A collective exchange is no boundary: its
    collective is captured into the home card's graph of the phase."""

    def __init__(self, span=None):
        self.span = span
        self.bufs: list[list[torch.Tensor]] = []
        self.calls = 0
        self.hosts: list[_Exchange] = []  # staged: a host part between phases each
        self.collectives: list[_Exchange] = []  # inside the phase graphs
        self.exchanges = 0
        self.recorder: _Recorder | None = None

    def __call__(self, ts, devs) -> list[torch.Tensor]:
        ts = list(ts)
        if self.calls == len(self.bufs):
            self.bufs.append([torch.empty_like(t, device=d) for t, d in zip(ts, devs)])
        dsts = self.bufs[self.calls]
        self.calls += 1
        if len(dsts) != len(ts) or any(d.shape != t.shape or d.dtype != t.dtype
                                       for d, t in zip(dsts, ts)):
            raise RuntimeError("a transfer of the mesh step changed between runs")
        if self.recorder is not None:
            self.recorder.boundary(functools.partial(_copy, dsts, ts))
        else:
            _copy(dsts, ts)
        return list(dsts)

    def exchange(self, kind: str, v: torch.Tensor, device) -> torch.Tensor:
        """``ProcessSpan.exchange`` through this body's static buffers.
        Collective: ``v`` reaches the home card (a transfer where it lies on
        another card), is copied into the send buffer, the collective runs
        (captured into the phase's graph), and the receive buffer is the
        result (a transfer to ``device`` where that is another card).
        Staged: the source copied into the send buffer at the end of a
        phase, the host part between the phases, the receive buffer copied
        to the static destination at the start of the next phase."""
        span = self.span
        made = self.collectives if span.transport == "collective" else self.hosts
        if self.exchanges == len(made):
            made.append(_Exchange(span, kind, v, device))
        ex = made[self.exchanges]
        self.exchanges += 1
        if not ex.fits(kind, v, device):
            raise RuntimeError("an exchange of the mesh step changed between runs")
        if span.transport == "collective":
            if v.device != span.home:
                (v,) = self([v], [span.home])
            ex.send.copy_(v)
            span.communicate(kind, ex.send, ex.recv)
            return ex.recv if ex.device == span.home else self([ex.recv], [ex.device])[0]
        ex.send.copy_(v, non_blocking=True)
        if self.recorder is not None:
            self.recorder.boundary(ex)
        else:
            ex()
        ex.dst.copy_(ex.recv, non_blocking=True)
        return ex.dst


class _MeshBody:
    """A :class:`StepGraphs` body run with its transfers through one
    :class:`_Transfers`."""

    def __init__(self, rx, body):
        self.rx, self.body, self.transfers = rx, body, _Transfers(rx._span)

    def __call__(self, state: dict | None = None) -> dict:
        t = self.transfers
        t.calls = t.exchanges = 0
        with self.rx._transfers(t, t.exchange):
            return self.body(state)


@contextlib.contextmanager
def _on_streams(streams):
    """Each stream the current one of its device while the context lasts."""
    with contextlib.ExitStack() as stack:
        for s in streams:
            stack.enter_context(torch.cuda.stream(s))
        yield


class MeshGraphs(StepGraphs):
    """:class:`StepGraphs` for a mesh: an entry's "graph" is its program of
    phase graphs, transfers and exchanges (:class:`_Program`)."""

    def __init__(self, rx):
        super().__init__(rx)
        self.pools: dict[torch.device, tuple] = {}
        self.streams: dict[torch.device, torch.cuda.Stream] = {}

    def _body(self, inp: torch.Tensor) -> _MeshBody:
        return _MeshBody(self.rx, super()._body(inp))

    def _capture(self, inp: torch.Tensor, raw: torch.Tensor, body: _MeshBody) -> _Entry:
        rx = self.rx
        mesh_cards = list(dict.fromkeys(_card(d) for d in rx.mesh.local()))
        restore, recorded = self._launch_counts()
        with torch.cuda.device(rx.device):
            inp.copy_(raw)
        sides = {d: torch.cuda.Stream(d) for d in mesh_cards}
        for d, s in sides.items():
            s.wait_stream(torch.cuda.current_stream(d))
        with _on_streams(sides.values()):
            scratch = rx.init_state()
            with _Cards() as used:
                body(scratch)
            for _ in range(WARMUP_STEPS - 1):
                body(scratch)
        for d, s in sides.items():
            torch.cuda.current_stream(d).wait_stream(s)
        del scratch
        restore()
        # a card of the mesh that computes nothing (2x2 over four cards: the
        # second time row's chan device) captures nothing: a pool all of
        # whose graphs were dropped cannot be captured into again
        cards = [d for d in mesh_cards if d in used.seen]
        for d in cards:
            if d not in self.pools:
                self.pools[d] = torch.cuda.graph_pool_handle()
                self.streams[d] = torch.cuda.Stream(d)
        rec = _Recorder(cards, self.pools)
        body.transfers.recorder = rec
        collecting = gc.isenabled()
        gc.collect()
        gc.disable()
        try:
            with _on_streams(self.streams[d] for d in cards), rec:
                try:
                    rec.open_phase()
                    outputs = body()
                    rec.close_phase()
                except BaseException:
                    # a capture ends only on the stream it began on
                    rec.abandon()
                    raise
        finally:
            body.transfers.recorder = None
            if collecting:
                gc.enable()
        rec.empty.clear()
        launches = recorded()
        restore()
        return _Entry(inp, body, _Program(rec.steps, cards, rx._span), outputs, launches)


class _Program:
    """A captured entry: per phase the graphs of the cards that compute in
    it, then what ends it: the copies of a transfer, the host part of a
    staged exchange, or nothing after the last phase.  Where the phases
    hold NCCL collectives (``span``), a replay ends with the host waiting,
    bounded, for every card's stream (``ProcessSpan.wait``)."""

    def __init__(self, steps: list[tuple[list, object]], cards=(), span=None):
        self.steps = steps
        self.cards = list(cards) if span is not None and span.backend == "nccl" else []
        self.span = span

    @property
    def graphs(self) -> int:
        """Graphs one replay launches."""
        return sum(len(g) for g, _ in self.steps)

    def replay(self) -> None:
        for graphs, after in self.steps:
            for g in graphs:
                g.replay()
            if after is not None:
                after()
        if self.cards:
            events = [torch.cuda.Event() for _ in self.cards]
            for ev, d in zip(events, self.cards):
                ev.record(torch.cuda.current_stream(d))
            self.span.wait(events)
