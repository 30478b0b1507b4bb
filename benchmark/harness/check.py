"""The comparison that decides ``correct``: the program's int16 audio of the
compared blocks against the reference's, topic by topic.

Numbers compared, each against its limit (PERF.md gives the readings each
limit was set from):

  max_lsb     the largest |program - reference| over every compared sample
  flip_share  the share of compared samples that differ at all
  malformed   outputs of the window that are not what the plan says: a
              missing topic, a wrong dtype or length, a ZMQ message that is
              not ``[5-byte topic | u32 rate | int16 payload]``
  missing     compared blocks whose outputs never came
"""

from __future__ import annotations

import sys

import numpy as np

__all__ = ["LIMITS", "Tally", "verdict"]

# between sound runs' largest reading (1 LSB, 0.0021 of samples) and the
# TF32 control's smallest (21 LSB, 0.81), nearer the lower (PERF.md §2)
LIMITS = {"max_lsb": 5, "flip_share": 0.05, "malformed": 0, "missing": 0}


class Tally:
    """Accumulates the comparison over the compared blocks."""

    def __init__(self):
        self.max_lsb = 0
        self.flips = 0
        self.samples = 0
        self.malformed = 0
        self.missing = 0

    def compare(self, got: dict[str, np.ndarray], want: dict[str, np.ndarray]) -> None:
        for topic, ref in want.items():
            a = got.get(topic)
            if a is None or a.dtype != np.int16 or a.shape != ref.shape:
                self.malformed += 1
                continue
            d = np.abs(a.astype(np.int32) - ref.astype(np.int32))
            self.max_lsb = max(self.max_lsb, int(d.max(initial=0)))
            self.flips += int(np.count_nonzero(d))
            self.samples += d.size

    def numbers(self) -> dict[str, float]:
        return {"max_lsb": self.max_lsb,
                "flip_share": self.flips / self.samples if self.samples else 1.0,
                "malformed": self.malformed, "missing": self.missing}


def verdict(numbers: dict[str, float]) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}); prints each number beside its
    limit as the last lines of standard error."""
    checks = {k: {"value": v, "limit": LIMITS[k]} for k, v in numbers.items()}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    for k, c in checks.items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    return ok, checks
