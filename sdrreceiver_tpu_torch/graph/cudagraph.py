"""One CUDA graph per step entry of a :class:`~.compiler.CompiledReceiver`.

Counterpart of the JAX package's compiled step, where each public entry is
one XLA executable, ``jax.jit(step, donate_argnums=(0,))``, and each burst
entry a ``lax.scan`` of k steps in one executable.  Here the first call of
an entry captures the step's CUDA work (its torch ops and both hand-written
kernels, all launched on the current stream) into one ``torch.cuda.CUDAGraph``;
every later call replays it.  The step stays defined in ``compiler.py``.

A graph reads and writes fixed buffers, so:

* **input**: each graph owns one ``[2T]`` (u8 or f32) or ``[k, 2T]`` buffer;
  a call copies the caller's block into it;
* **state, donated as in JAX**: the receiver owns one set of state buffers,
  shared by all its graphs, and each graph ends by writing the new state
  into them (:func:`write_back`).  A call returns those buffers; a state
  passed in that is not the one returned last (a fresh ``init_state()``, an
  ``import_state()`` result, another receiver's) is copied in first.  So the
  state passed to a step is consumed: a caller that needs it later exports
  or clones it first;
* **outputs**: the next replay rewrites the graph's own output tensors, so
  each call returns copies, which stay valid as JAX arrays do.

A burst graph runs k steps on one state (:func:`run_burst`) with the
outputs stacked on a leading k axis: the operations of k single steps, so
their bits.  The graphs of one receiver share one memory pool.  Replays run
one at a time on the receiver's stream and every output is copied out right
after its replay, so no graph's temporaries overwrite what a caller holds.

Before its capture a graph's body runs :data:`WARMUP_STEPS` times on a side
stream against a throwaway ``init_state()`` (torch's capture rule: nvcc's
library, the DC kernel's decay table, cuDNN and cuFFT set themselves up
there, outside the capture).  Those runs launch the kernels on no block of
the stream, so the wrappers' ``launches`` counts are put back after them;
the capture records launches without running them, and each replay adds
what it recorded.  A failed capture or replay raises; nothing falls back to
the eager step.  While tracing is on (``obs.trace``) each capture, its
warm-up runs included, is the span ``step.capture`` and adds one to the
counter ``step.captures`` and its ns to ``step.capture_ns``; a step
records the block's step-start timing event directly before its input
copy, its first stream work once the state needs no write-back.

On a CPU receiver nothing is captured: every call runs the same in-place
body on the same static buffers.  That is how the CPU tests hold what a
graph records.
"""

from __future__ import annotations

import time
from typing import Any, Callable

import torch

from ..obs import trace

__all__ = ["StepGraphs", "flatten", "write_back", "run_burst", "WARMUP_STEPS"]

WARMUP_STEPS = 2

Step = Callable[[dict, torch.Tensor], tuple[dict, dict]]


def flatten(tree, prefix: str = ""):
    """(path, tensor) leaves of a nested dict/list state, paths joined by
    '/' (the JAX package's pytree key paths)."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        key = f"{prefix}{k}"
        if isinstance(v, (dict, list)):
            yield from flatten(v, key + "/")
        else:
            yield key, v


def _rebuild(tree):
    """The same nested dicts/lists anew, around the same leaves."""
    if isinstance(tree, dict):
        return {k: _rebuild(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_rebuild(v) for v in tree]
    return tree


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def write_back(dst: dict, new: dict, outputs: dict | None = None) -> None:
    """Copy the state ``new`` into the leaves of ``dst`` (one structure).

    A leaf of ``new`` that IS ``dst``'s leaf at its path is left alone.  One
    that shares memory with any leaf of ``dst`` otherwise (a view of an old
    leaf, or an old leaf at another path) is cloned before any copy, so no
    copy reads what another wrote; so is each entry of ``outputs`` (updated
    in place) that shares memory with ``dst``.  Raises ``ValueError`` where
    the structures, shapes, dtypes or devices differ."""
    d, n = dict(flatten(dst)), dict(flatten(new))
    if d.keys() != n.keys():
        raise ValueError(f"state leaves differ: {sorted(d.keys() ^ n.keys())}")
    held = {_storage(t) for t in d.values() if t.numel()}

    def unaliased(t: torch.Tensor) -> torch.Tensor:
        return t.clone() if t.numel() and _storage(t) in held else t

    dsts, srcs = [], []
    for key, t in d.items():
        v = n[key]
        if v is t:
            continue
        if v.shape != t.shape or v.dtype != t.dtype or v.device != t.device:
            raise ValueError(f"state {key!r}: {v.dtype} {tuple(v.shape)} on {v.device}, "
                             f"expected {t.dtype} {tuple(t.shape)} on {t.device}")
        dsts.append(t)
        srcs.append(unaliased(v))
    if outputs is not None:
        for key, v in outputs.items():
            outputs[key] = unaliased(v)
    if dsts:
        torch._foreach_copy_(dsts, srcs)


def run_burst(step: Step, state: dict, raws: torch.Tensor) -> tuple[dict, dict]:
    """k steps over ``raws [k, 2T]``: the last state, and the outputs
    stacked on a leading k axis (the JAX package's ``lax.scan``)."""
    outs = []
    for raw in raws:
        state, o = step(state, raw)
        outs.append(o)
    return state, {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


class _Entry:
    """One entry's static input, its body, and on the card its graph (or
    anything with a ``replay()``), the outputs the graph writes and the
    launches one replay makes (wrapper, count)."""

    def __init__(self, inp, body, graph=None, outputs=None, launches=()):
        self.input, self.body, self.graph = inp, body, graph
        self.outputs, self.launches = outputs, launches


class StepGraphs:
    """The graphs of one receiver, one per (input dtype, shape): the single
    step ``[2T]`` and each burst ``[k, 2T]``, u8 or f32 (``step_iq`` takes
    the f32 graphs).  :meth:`step` captures an entry's graph on its first
    call and replays it from then on."""

    def __init__(self, rx):
        self.rx = rx
        self.state: dict | None = None  # the static state buffers
        self.pool = None
        self._entries: dict[tuple, _Entry] = {}

    def step(self, state: dict, raw: torch.Tensor) -> tuple[dict, dict]:
        """``(state, outputs)`` of one block ``raw [2T]`` or a burst ``raw
        [k, 2T]`` (outputs stacked), as the eager step gives them; the state
        returned is the receiver's buffers, the outputs are copies."""
        key = (raw.dtype, tuple(raw.shape))
        entry = self._entries.get(key)
        if entry is None:
            entry = self._entries[key] = self._build(raw)
        write_back(self.state, state)
        tr = trace.current()
        if tr is not None and tr.timing is not None:
            tr.mark(2)  # the step's stream work starts here: the host's part is done
        entry.input.copy_(raw)
        if entry.graph is None:
            outputs = entry.body()
        else:
            entry.graph.replay()
            outputs = entry.outputs
            for w, n in entry.launches:
                w.launches += n
        return _rebuild(self.state), {k: v.clone() for k, v in outputs.items()}

    def _build(self, raw: torch.Tensor) -> _Entry:
        rx = self.rx
        if self.state is None:
            self.state = rx.init_state()
        inp = torch.empty(raw.shape, dtype=raw.dtype, device=rx.device)
        body = self._body(inp)
        if not self.captures:
            return _Entry(inp, body)
        t0 = time.monotonic_ns()
        entry = self._capture(inp, raw, body)
        tr = trace.current()
        if tr is not None:
            t1 = time.monotonic_ns()
            tr.span("step.capture", t0, t1, block=-1, child=False)
            tr.add("step.captures")
            tr.add("step.capture_ns", t1 - t0)
        return entry

    @property
    def captures(self) -> bool:
        """Whether entries capture a graph: on the card."""
        return self.rx.device.type == "cuda"

    def _body(self, inp: torch.Tensor):
        rx = self.rx

        def body(state: dict | None = None) -> dict:
            """What the graph records: the step (a burst: k steps) on
            ``state`` (default: the state buffers), the new state written
            back into its leaves; returns the outputs."""
            state = self.state if state is None else state
            new, outputs = (run_burst(rx._step_raw, state, inp) if inp.dim() == 2
                            else rx._step_raw(state, inp))
            write_back(state, new, outputs)
            return outputs

        return body

    def _launch_counts(self):
        """``(restore, recorded)`` over the kernel wrappers' ``launches``
        as they stand now: ``restore()`` puts them back, ``recorded()``
        gives the (wrapper, launches) made since."""
        rx = self.rx
        wrappers: list[Any] = [rx.dc_ingest, *(mc for mc, _ in rx.mix_cascades().values())]
        counts = [w.launches for w in wrappers]

        def restore() -> None:
            for w, n in zip(wrappers, counts):
                w.launches = n

        def recorded() -> tuple:
            return tuple((w, w.launches - n) for w, n in zip(wrappers, counts) if w.launches != n)

        return restore, recorded

    def _capture(self, inp: torch.Tensor, raw: torch.Tensor, body) -> _Entry:
        rx = self.rx
        dev = rx.device
        restore, recorded = self._launch_counts()
        with torch.cuda.device(dev):
            inp.copy_(raw)
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                scratch = rx.init_state()
                for _ in range(WARMUP_STEPS):
                    body(scratch)
            torch.cuda.current_stream(dev).wait_stream(side)
            del scratch
            restore()
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph()
            # thread_local: a live source's threads may use the card meanwhile
            with torch.cuda.graph(graph, pool=self.pool, capture_error_mode="thread_local"):
                outputs = body()
        launches = recorded()
        restore()
        return _Entry(inp, body, graph, outputs, launches)
