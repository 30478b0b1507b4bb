"""CUDA graphs for the step entries of a :class:`~.sharded.ShardedReceiver`
whose mesh lives in one process: one graph per phase and card.

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
* a **phase** is the compute between two transfers.  Each card that
  computes in it has one graph holding the work of all its shards.

Replaying an entry runs, phase by phase, the graphs of the cards that
compute in it and then the transfer's copies.  Each card's stream keeps
its own order, and torch's copy between two cards waits on both cards'
streams, so nothing waits on the host.  A mesh on one card (``[cuda:0] *
4``) takes the same path, one graph per phase, so one card runs the code
that four run.

Everything else is :class:`~..graph.cudagraph.StepGraphs`': one set of
graphs per entry (the single step, each burst size k with k steps of
phases), ``WARMUP_STEPS`` runs of the body on side streams against a
throwaway state before the capture (every card's), one memory pool per
card, the state donated (the receiver's buffers on the home device updated
in place), the outputs copied out after the last phase, and each replay
adding to the wrappers' ``launches`` what its capture recorded.  A failed
capture raises; no phase falls back to the eager step.

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
transfers copying into the same static buffers; that is what the CPU
tests hold.
"""

from __future__ import annotations

import contextlib
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
    """The capture of one entry: between two transfers every card's
    capture is open; :meth:`boundary` closes them, keeps the graphs of the
    cards that computed, and records the transfer's copies."""

    def __init__(self, cards: list[torch.device], pools: dict):
        super().__init__()
        self.cards, self.pools = cards, pools
        self.steps: list[tuple[list, tuple | None]] = []
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

    def close_phase(self, copies: tuple | None = None) -> None:
        self.checking = False
        kept = []
        for d, g in list(self.open.items()):
            with torch.cuda.device(d), warnings.catch_warnings():
                warnings.simplefilter("ignore")  # an empty graph warns; it is dropped
                g.capture_end()
            del self.open[d]
            (kept if d in self.touched else self.empty).append(g)
        self.steps.append((kept, copies))

    def boundary(self, srcs: list[torch.Tensor], dsts: list[torch.Tensor]) -> None:
        self.close_phase((dsts, srcs))
        self.open_phase()

    def abandon(self) -> None:
        """End the captures left open by a failure (their graphs are
        discarded) so the cards' streams leave capture mode."""
        self.checking = False
        for d, g in self.open.items():
            with torch.cuda.device(d), contextlib.suppress(RuntimeError), \
                    warnings.catch_warnings():
                warnings.simplefilter("ignore")
                g.capture_end()
        self.open = {}


class _Transfers:
    """The transfers of one entry's body, in call order: the k-th call of
    a run copies its tensors into the k-th set of static buffers (made on
    the first run), so every run moves the same data between the same
    buffers.  While ``recorder`` captures, each call is a phase boundary
    and its copies are recorded for the replays instead of made."""

    def __init__(self):
        self.bufs: list[list[torch.Tensor]] = []
        self.calls = 0
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
            self.recorder.boundary(ts, dsts)
        else:
            _copy(dsts, ts)
        return list(dsts)


class _MeshBody:
    """A :class:`StepGraphs` body run with its transfers through one
    :class:`_Transfers`."""

    def __init__(self, rx, body):
        self.rx, self.body, self.transfers = rx, body, _Transfers()

    def __call__(self, state: dict | None = None) -> dict:
        self.transfers.calls = 0
        with self.rx._transfers(self.transfers):
            return self.body(state)


@contextlib.contextmanager
def _on_streams(streams):
    """Each stream the current one of its device while the context lasts."""
    with contextlib.ExitStack() as stack:
        for s in streams:
            stack.enter_context(torch.cuda.stream(s))
        yield


class MeshGraphs(StepGraphs):
    """:class:`StepGraphs` for a mesh in one process: an entry's "graph"
    is its program of phase graphs and transfers (:class:`_Program`)."""

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
                rec.open_phase()
                outputs = body()
                rec.close_phase()
        except BaseException:
            rec.abandon()
            raise
        finally:
            body.transfers.recorder = None
            if collecting:
                gc.enable()
        rec.empty.clear()
        launches = recorded()
        restore()
        return _Entry(inp, body, _Program(rec.steps), outputs, launches)


class _Program:
    """A captured entry: per phase the graphs of the cards that compute in
    it, then the copies of the transfer that ends it."""

    def __init__(self, steps: list[tuple[list, tuple | None]]):
        self.steps = steps

    @property
    def graphs(self) -> int:
        """Graphs one replay launches."""
        return sum(len(g) for g, _ in self.steps)

    def replay(self) -> None:
        for graphs, copies in self.steps:
            for g in graphs:
                g.replay()
            if copies is not None:
                _copy(*copies)
