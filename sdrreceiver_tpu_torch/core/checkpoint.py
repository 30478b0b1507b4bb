"""Streaming-state checkpoint/resume (port of ``sdrreceiver_tpu.core.checkpoint``).

A checkpoint is the CANONICAL named state (``CompiledReceiver.export_state``)
in a compressed ``.npz`` with the plan fingerprint beside it.  The layout and
the fingerprint are the JAX package's, so a file saved by either package's
CLI resumes in the other; a checkpoint against a changed config is refused.
numpy only.
"""

from __future__ import annotations

import hashlib
import io as _io
import json
import pathlib

import numpy as np

__all__ = ["plan_fingerprint", "save_state", "load_state"]


def plan_fingerprint(plan) -> str:
    """Stable hash of the execution-relevant plan fields (every value a
    Python int or bool, as the JAX package's JSON sees them)."""
    desc = {
        "fs": int(plan.fs),
        "center": int(plan.center_frequency),
        "dc": bool(plan.dc_correct),
        "groups": [
            {
                "mixer": int(g.mixer_freq),
                "stages": int(g.stages),
                "direct": bool(g.direct),
                "buckets": [
                    {
                        "stages": int(b.stages),
                        "late": int(b.late_factor),
                        "out": int(b.out_rate),
                        "mixers": [int(m) for m in b.mixer_freqs()],
                        "fbw": [int(s.filter_bandwidth) for s in b.subs],
                    }
                    for b in g.buckets
                ],
            }
            for g in plan.groups
        ],
    }
    return hashlib.sha256(json.dumps(desc, sort_keys=True).encode()).hexdigest()[:16]


def save_state(path: str | pathlib.Path, named: dict, plan) -> None:
    """Write canonical named state leaves (from ``rx.export_state(state)``)."""
    arrays = {k: np.asarray(v) for k, v in named.items()}
    arrays["__fingerprint__"] = np.frombuffer(
        plan_fingerprint(plan).encode(), dtype=np.uint8
    )
    buf = _io.BytesIO()
    np.savez_compressed(buf, **arrays)
    pathlib.Path(path).write_bytes(buf.getvalue())


def load_state(path: str | pathlib.Path, plan) -> dict:
    """Read canonical named state leaves (feed to ``rx.import_state``),
    after checking the plan fingerprint."""
    with np.load(pathlib.Path(path), allow_pickle=False) as z:
        fp = bytes(z["__fingerprint__"]).decode()
        if fp != plan_fingerprint(plan):
            raise ValueError(
                f"checkpoint fingerprint {fp} does not match the current plan "
                f"{plan_fingerprint(plan)}: config changed since the save"
            )
        return {k: z[k] for k in z.files if k != "__fingerprint__"}
