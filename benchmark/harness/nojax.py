"""The check that the run loaded no JAX: neither JAX and its companions nor
the JAX package the program was ported from.  Module names are compared by
their top-level name, whole: ``sdrreceiver_tpu_torch`` is the program and
is not ``sdrreceiver_tpu``."""

from __future__ import annotations

import sys

__all__ = ["FORBIDDEN", "loaded"]

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "sdrreceiver_tpu"})


def loaded(modules=None) -> list[str]:
    """The forbidden top-level names among ``modules`` (``sys.modules``)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)
