"""Throughput/latency counters and the static cost model of a plan.

Port of ``sdrreceiver_tpu.obs.metrics`` (numpy only): every pipeline run
tracks samples in, wall time and percentiles of the host's time per block
(``host_ms_per_block``, which the JAX package names ``block_latency_ms``),
on ``time.monotonic``; its other summary keys are the JAX package's, and
``published_early`` (the units ``run_pipeline`` published before pulling
the next block) is the port's own.  ``plan_cost_model`` gives the FLOPs
and bytes per ingest block of a ReceiverPlan.
"""

from __future__ import annotations

import dataclasses
import json
import time

import numpy as np

__all__ = ["PipelineMetrics", "plan_cost_model", "group_cost_model"]


@dataclasses.dataclass
class PipelineMetrics:
    samples_in: int = 0
    blocks: int = 0
    dropped_blocks: int = 0
    messages_sent: int = 0
    published_early: int = 0
    started_at: float = 0.0
    finished_at: float = 0.0
    block_seconds: list[float] = dataclasses.field(default_factory=list)
    pacing_slack_seconds: list[float] = dataclasses.field(default_factory=list)

    def start(self) -> None:
        self.started_at = time.monotonic()

    def finish(self) -> None:
        self.finished_at = time.monotonic()

    def record_block(
        self,
        n_samples: int,
        seconds: float,
        sent: int = 0,
        pacing_slack: float | None = None,
    ) -> None:
        """``seconds`` is COMPUTE time (dispatch, and the publish of the
        previous block or of this one), excluding any realtime pacing sleep; the sleep's headroom is
        reported separately as ``pacing_slack`` (negative = falling behind
        realtime)."""
        self.samples_in += n_samples
        self.blocks += 1
        self.messages_sent += sent
        self.block_seconds.append(seconds)
        if pacing_slack is not None:
            self.pacing_slack_seconds.append(pacing_slack)

    @property
    def wall_seconds(self) -> float:
        end = self.finished_at or time.monotonic()
        return max(end - self.started_at, 1e-12)

    @property
    def samples_per_second(self) -> float:
        return self.samples_in / self.wall_seconds

    def summary(self) -> dict:
        lat = np.asarray(self.block_seconds[1:] or [0.0])  # skip compile block
        out = {
            "samples_in": self.samples_in,
            "blocks": self.blocks,
            "dropped_blocks": self.dropped_blocks,
            "messages_sent": self.messages_sent,
            "published_early": self.published_early,
            "wall_seconds": round(self.wall_seconds, 6),
            "msamples_per_second": round(self.samples_per_second / 1e6, 3),
            "host_ms_per_block": {
                "p50": round(float(np.percentile(lat, 50)) * 1e3, 3),
                "p95": round(float(np.percentile(lat, 95)) * 1e3, 3),
                "max": round(float(lat.max()) * 1e3, 3),
            },
        }
        if self.pacing_slack_seconds:
            slack = np.asarray(self.pacing_slack_seconds[1:] or [0.0])
            out["pacing_slack_ms"] = {
                "p50": round(float(np.percentile(slack, 50)) * 1e3, 3),
                "min": round(float(slack.min()) * 1e3, 3),
                "behind_blocks": int((slack < 0).sum()),
            }
        return out

    def dump(self) -> str:
        return json.dumps(self.summary())


def group_cost_model(plan, block: int | None = None) -> dict[int, dict]:
    """Per-group FLOPs/output-bytes per ingest block: the one cost function
    that plan_cost_model sums (the JAX package's dist.multihost also
    partitions hosts by it)."""
    t = block or plan.block_samples
    out: dict[int, dict] = {}
    for g in plan.groups:
        flops = 0.0
        tg = t
        if not g.direct:
            flops += 8.0 * t  # complex NCO multiply (+ phasor ~transcendental)
            for s in range(g.stages):
                # 11-tap half-band on I and Q at output rate: count the
                # algorithmic 2*(ntaps) MAC upper bound
                tg //= 2
                flops += 2.0 * 2.0 * 11.0 * tg
            tg = t >> g.stages
        bytes_out = 0.0
        for b in g.buckets:
            c = b.channels
            tb = tg
            flops += 8.0 * c * tg  # per-channel mix
            for s in range(b.stages):
                tb //= 2
                flops += 2.0 * 2.0 * 11.0 * c * tb
            if b.late_factor > 1:
                nl = len(b.late_taps())
                tb //= b.late_factor
                flops += 2.0 * 2.0 * nl * c * tb
            # USB: hilbert 125-tap + delay + subtract
            flops += c * tb * (2.0 * 125.0 + 2.0)
            at = b.audio_taps()
            if at is not None:
                flops += c * tb * 2.0 * at.shape[1]
            flops += 3.0 * c * tb  # gain + round + clip
            bytes_out += 2.0 * c * tb  # int16 audio
        out[g.index] = {"flops_per_block": flops, "bytes_out": bytes_out}
    return out


def plan_cost_model(plan, block: int | None = None) -> dict:
    """Static FLOPs/bytes per ingest block for a ReceiverPlan, the roofline
    numerator and denominator.  Sums :func:`group_cost_model` plus the
    shared DC front end."""
    t = block or plan.block_samples
    groups = group_cost_model(plan, t)
    flops = sum(g["flops_per_block"] for g in groups.values())
    if plan.dc_correct:
        flops += 8.0 * t  # complex EMA + subtract
    bytes_in = 8.0 * t  # complex64 ingest
    bytes_out = sum(g["bytes_out"] for g in groups.values())
    return {
        "block_samples": t,
        "flops_per_block": flops,
        "bytes_per_block": bytes_in + bytes_out,
        "flops_per_input_sample": flops / t,
        "arithmetic_intensity": flops / (bytes_in + bytes_out),
    }
