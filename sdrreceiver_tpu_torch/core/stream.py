"""Block-streaming substrate on tensors (port of ``sdrreceiver_tpu.core.stream``).

Every block function has the form ``state', y = block_fn(state, x)`` with
``x``/``y`` channel-batched tensors and ``state`` the carried DSP state.  The
property every kernel keeps: processing a signal in chunks equals processing
it whole (the reference's FIRQueueBackToFront handoff, jonti/dsp.cpp:163-173).
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, TypeVar

import numpy as np
import torch

State = Any
T = TypeVar("T")

__all__ = ["fir_history_init", "run_chunked", "concat_outputs", "tree_allclose"]


def fir_history_init(
    channels: int | None,
    ntaps: int,
    dtype: torch.dtype = torch.complex64,
    device: torch.device | str = "cpu",
) -> torch.Tensor:
    """Zero history for an ``ntaps``-tap filter: the last ``ntaps - 1``
    inputs, zero like the reference's freshly zeroed queue
    (jonti/dsp.cpp:46-49)."""
    shape = (ntaps - 1,) if channels is None else (channels, ntaps - 1)
    return torch.zeros(shape, dtype=dtype, device=device)


def run_chunked(
    block_fn: Callable[[State, torch.Tensor], tuple[State, T]],
    state: State,
    x: torch.Tensor,
    chunk: int,
) -> tuple[State, list[T]]:
    """Drive ``block_fn`` over ``x`` cut into ``chunk``-long slices of its
    last (time) axis, which must divide evenly."""
    total = x.shape[-1]
    if total % chunk:
        raise ValueError(f"time length {total} not divisible by chunk {chunk}")
    outs: list[T] = []
    for start in range(0, total, chunk):
        state, y = block_fn(state, x[..., start : start + chunk])
        outs.append(y)
    return state, outs


def _leaves(tree: Any) -> tuple[list, Any]:
    """(leaves, structure) of nested dicts / lists / tuples."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_leaves(tree[k]) for k in keys]
        return [x for p in parts for x in p[0]], ("dict", keys, [p[1] for p in parts])
    if isinstance(tree, (list, tuple)):
        parts = [_leaves(v) for v in tree]
        return [x for p in parts for x in p[0]], (type(tree).__name__, [p[1] for p in parts])
    return [tree], None


def concat_outputs(outs: Iterable[Any]) -> Any:
    """Concatenate identically structured outputs (tensors, or dicts /
    lists / tuples of them) along the trailing (time) axis."""
    outs = list(outs)
    first = outs[0]
    if isinstance(first, dict):
        return {k: concat_outputs(o[k] for o in outs) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(concat_outputs(o[i] for o in outs) for i in range(len(first)))
    return torch.cat(outs, dim=-1)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def tree_allclose(a: Any, b: Any, rtol=1e-5, atol=1e-6) -> bool:
    """Structural allclose over two nested states (test helper)."""
    la, ta = _leaves(a)
    lb, tb = _leaves(b)
    if ta != tb:
        return False
    return all(np.allclose(_np(x), _np(y), rtol=rtol, atol=atol) for x, y in zip(la, lb))
