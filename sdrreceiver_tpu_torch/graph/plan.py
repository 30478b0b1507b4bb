"""The channelizer plan compiler: config -> static execution plan.

Numpy-only port of ``sdrreceiver_tpu.graph.plan`` (same rules, same
dataclasses field for field; tests pin ``build_plan`` equal to it).

This is the framework's equivalent of the reference's MainWindow constructor
(mainwindow.cpp:67-235), which decides — at startup, from the ini — every
decimation schedule, mixer frequency, filter design and buffer size.  Here
those decisions produce an immutable :class:`ReceiverPlan` that the graph
compiler turns into one block step.

Planning rules reproduced exactly (SURVEY.md section 2.5):

  * buffer split: ``buflen = 2*Fs/4`` bytes, or ``2*Fs/5`` when ``2*Fs/4`` is
    not a multiple of 512 (mainwindow.cpp:67-81)
  * main VFO: ``stages = log2(Fs/out)`` (0 when ratio 1), mixer =
    ``center - freq`` (mainwindow.cpp:130-131)
  * sub default out_rate from data_rate: 600->12000, 1200->24000, else 48000
    (mainwindow.cpp:155-171)
  * sub->main matching: first main with ``|main_freq - sub_freq| <
    main.out_rate`` (mainwindow.cpp:178-191); unmatched subs get the
    reference's fallback parameters (Fs_in = Fs, mixer = center - freq) and
    are planned as a direct-from-input group — the reference would misprocess
    them through main[0] (mainwindow.cpp:225 pushes to VFOsub[0] even without
    a match); this framework runs them at the rate their parameters assume
  * late decimation: ``main_out/48000 == 5`` -> /5, ``== 6`` -> /6, with
    ``stages = log2(main_out/(L*out))``; else pure power-of-two chain
    ``log2(Fs/out) - log2(Fs/main_out)`` (mainwindow.cpp:196-216)
  * sub mixer = ``(center - main_mixer) - (freq + mix_offset)``
    (mainwindow.cpp:151,220); gain = ini gain / 100 (mainwindow.cpp:219)

Channels are then BUCKETED: all subs of a group sharing a decimation schedule
``(stages, late_factor)`` become one ``[C, T]`` tensor batch (the batched
replacement for the reference's serial loop over vfo objects,
sdrj.cpp:288-294).  Per-channel audio filters live as padded rows of one
grouped-conv filter bank; unfiltered channels get a delta tap.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np

from ..kernels import design, polyphase
from .config import MainVfoConfig, ReceiverConfig, SubVfoConfig

__all__ = ["SubPlan", "BucketPlan", "GroupPlan", "ReceiverPlan", "build_plan"]


def _exact_log2(ratio_num: int, ratio_den: int, what: str) -> int:
    """log2 of an exact integer power-of-two ratio; raises otherwise.

    The reference silently floors log2 (mainwindow.cpp:130,200-214); all
    shipped configs use exact powers, and a non-exact ratio means a chain
    whose rates don't compose, so the planner rejects it loudly.
    """
    if ratio_num % ratio_den:
        raise ValueError(f"{what}: {ratio_num}/{ratio_den} is not an integer")
    q = ratio_num // ratio_den
    if q <= 0 or (q & (q - 1)):
        raise ValueError(f"{what}: ratio {q} is not a power of two")
    return q.bit_length() - 1


def default_out_rate(data_rate: int) -> int:
    """data_rate -> audio out_rate table (mainwindow.cpp:155-171)."""
    return {600: 12000, 1200: 24000}.get(data_rate, 48000)


@dataclasses.dataclass(frozen=True)
class SubPlan:
    """One demodulated channel (leaf VFO)."""

    topic: str
    frequency: int  # RF Hz incl. mix_offset (the reference's vfo_freq)
    mixer_freq: int  # Hz at the group rate
    out_rate: int
    gain: float  # effective (ini / 100)
    filter_bandwidth: int  # 0 = no audio LPF
    config_index: int  # position in [vfos] (for stable topic ordering)


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """Channels of one group sharing a decimation schedule -> one batch."""

    stages: int  # half-band /2 count after the group
    late_factor: int  # 1 (none), 5 or 6
    out_rate: int
    subs: tuple[SubPlan, ...]
    #: NCO phase modulus override; 0 = the group's out_rate.  Strict-
    #: reference unmatched subs keep the reference's full-rate oscillator
    #: (built for Fs but ticked once per group-rate sample,
    #: mainwindow.cpp:175-225 + oscillator.cpp:9-11), i.e. the phase
    #: advances by mixer_freq per SAMPLE modulo the INPUT Fs.
    nco_fs: int = 0

    def mix_fs(self, group_out_rate: int) -> int:
        """The modulus for this bucket's NCO phase arithmetic."""
        return self.nco_fs or group_out_rate

    @property
    def channels(self) -> int:
        return len(self.subs)

    def mixer_freqs(self) -> np.ndarray:
        return np.array([s.mixer_freq for s in self.subs], dtype=np.int64)

    def gains(self) -> np.ndarray:
        return np.array([s.gain for s in self.subs], dtype=np.float32)

    def late_taps(self) -> np.ndarray | None:
        if self.late_factor == 1:
            return None
        # Leading zero tap: the reference's plain FIR reads the N samples
        # EXCLUDING the one just written (FIRUpdateAndProcess walks an
        # (N+1)-slot ring starting after the write, jonti/dsp.cpp:59-71), so
        # fir_decI/Q carry one extra sample of delay; conv with [0, c...]
        # reproduces it exactly — pinned against the compiled reference's /5
        # and /6 chains in tests/test_oracle.py::TestChainOracleAltRates.
        t = polyphase.late_decim_taps(self.out_rate, self.late_factor)
        return np.concatenate([[np.float32(0.0)], t])

    def audio_taps(self) -> np.ndarray | None:
        """Padded per-channel audio low-pass bank ``[C, maxN]``; None when no
        channel filters.  Design per vfo.cpp:106-124:
        low_pass(2, out_rate, bw, bw/4, HAMMING); delta row = passthrough.

        Filter rows get a leading zero tap — fir_usb is the reference's
        plain FIR, which delays by one extra sample (jonti/dsp.cpp:59-71;
        see late_taps).  Delta (no-filter) rows stay a bare delta: the
        reference skips fir_usb entirely for them (vfo.cpp:318-326), so
        they carry NO extra delay."""
        if all(s.filter_bandwidth <= 0 for s in self.subs):
            return None
        rows = []
        for s in self.subs:
            if s.filter_bandwidth > 0:
                t = design.low_pass(
                    2.0,
                    float(self.out_rate),
                    float(s.filter_bandwidth),
                    s.filter_bandwidth / 4.0,
                    design.Window.HAMMING,
                )
                rows.append(np.concatenate([[np.float32(0.0)], t]))
            else:
                rows.append(np.array([1.0], dtype=np.float32))
        maxn = max(len(r) for r in rows)
        bank = np.zeros((len(rows), maxn), dtype=np.float32)
        for i, r in enumerate(rows):
            bank[i, : len(r)] = r
        return bank


@dataclasses.dataclass(frozen=True)
class GroupPlan:
    """A main VFO: one wideband mix + /2 cascade feeding its sub buckets.

    ``direct=True`` marks the synthetic group for subs that matched no main
    (it runs straight off the input stream)."""

    index: int
    frequency: int  # RF Hz (0 for the direct group)
    mixer_freq: int  # center - frequency
    out_rate: int
    stages: int
    buckets: tuple[BucketPlan, ...]
    zmq_address: str = ""
    zmq_topic: str = ""
    compress_scale: int = 1
    direct: bool = False

    @property
    def publishes_iq(self) -> bool:
        return bool(self.zmq_address and self.zmq_topic)


@dataclasses.dataclass(frozen=True)
class ReceiverPlan:
    fs: int
    center_frequency: int
    dc_correct: bool
    zmq_address: str  # bound PUB socket shared by all demod channels
    mix_offset: int
    bufsplit: int  # callbacks per second: 4 or 5
    block_samples: int  # complex samples per ingest block (buflen/2)
    groups: tuple[GroupPlan, ...]

    @property
    def buflen_bytes(self) -> int:
        return 2 * self.block_samples

    def num_channels(self) -> int:
        return sum(b.channels for g in self.groups for b in g.buckets)

    def all_topics(self) -> list[str]:
        subs = [s for g in self.groups for b in g.buckets for s in b.subs]
        return [s.topic for s in sorted(subs, key=lambda s: s.config_index)]

    def block_divisor(self) -> int:
        """The block length (in input samples) must be a multiple of this for
        every stage of every chain to divide evenly."""
        d = 1
        for g in self.groups:
            gdiv = 1 << g.stages
            for b in g.buckets:
                gdiv = max(gdiv, (1 << (g.stages + b.stages)) * b.late_factor)
            d = int(np.lcm(d, gdiv))
        return d


def _plan_buffer(fs: int) -> tuple[int, int]:
    """(bufsplit, block_samples) per mainwindow.cpp:67-81."""
    if ((2 * fs) // 4) % 512:
        return 5, ((2 * fs) // 5) // 2
    return 4, ((2 * fs) // 4) // 2


def _plan_sub(
    cfg: ReceiverConfig,
    sub: SubVfoConfig,
    idx: int,
    mains: list[GroupPlan],
) -> tuple[int | None, SubPlan, int, int]:
    """Returns (matched group index or None, SubPlan, stages, late_factor)."""
    vfo_freq = sub.frequency + cfg.mix_offset
    out_rate = sub.out_rate
    if out_rate == 0 and sub.data_rate > 0:
        out_rate = default_out_rate(sub.data_rate)
    if out_rate == 0:
        raise ValueError(
            f"vfo {idx + 1} ({sub.topic!r}): neither out_rate nor data_rate set"
        )

    match_idx: int | None = None
    main_mixer = 0
    main_out = cfg.sample_rate
    for g in mains:
        if abs(g.frequency - vfo_freq) < g.out_rate:
            match_idx = g.index
            main_mixer = g.mixer_freq
            main_out = g.out_rate
            break

    fs = cfg.sample_rate
    if main_out // 48000 == 5:
        late = 5
        stages = _exact_log2(main_out, late * out_rate, f"vfo {sub.topic} /5 chain")
    elif main_out // 48000 == 6:
        late = 6
        stages = _exact_log2(main_out, late * out_rate, f"vfo {sub.topic} /6 chain")
    else:
        late = 1
        stages = _exact_log2(fs, out_rate, f"vfo {sub.topic} chain") - _exact_log2(
            fs, main_out, f"vfo {sub.topic} main chain"
        )
        if stages < 0:
            raise ValueError(
                f"vfo {sub.topic}: out_rate {out_rate} above group rate {main_out}"
            )

    plan = SubPlan(
        topic=sub.topic,
        frequency=vfo_freq,
        mixer_freq=(cfg.center_frequency - main_mixer) - vfo_freq,
        out_rate=out_rate,
        gain=float(sub.gain) / 100.0,
        filter_bandwidth=sub.filter_bandwidth,
        config_index=idx,
    )
    return match_idx, plan, stages, late


def build_plan(
    cfg: ReceiverConfig, strict_reference: bool = False
) -> ReceiverPlan:
    """Compile the config into an execution plan.

    ``strict_reference``: reproduce the reference's handling of sub VFOs
    that match NO main VFO.  The reference pushes them into main group 0
    anyway (``VFOsub[main_idx]`` with ``main_idx`` still 0,
    mainwindow.cpp:175-226) with parameters computed for the RAW input
    stream (mixer = center - freq, stages = log2(Fs/out), oscillator
    modulus Fs) — so they process group 0's decimated baseband with a
    full-rate chain: wrong rate, wrong band, but exactly what the
    reference publishes.  Default (False): plan them as a direct-from-
    input group running at the rate their parameters assume, with a
    warning (the divergence is also documented in PARITY.md)."""
    cfg.validate()
    fs = cfg.sample_rate
    bufsplit, block_samples = _plan_buffer(fs)

    mains: list[GroupPlan] = []
    for i, m in enumerate(cfg.main_vfos):
        stages = (
            0
            if fs // m.out_rate == 1
            else _exact_log2(fs, m.out_rate, f"main vfo {i + 1}")
        )
        mains.append(
            GroupPlan(
                index=i,
                frequency=m.frequency,
                mixer_freq=cfg.center_frequency - m.frequency,
                out_rate=m.out_rate,
                stages=stages,
                buckets=(),
                zmq_address=m.zmq_address,
                zmq_topic=m.zmq_topic,
                compress_scale=m.compress_scale if m.compress_scale > 0 else 1,
            )
        )

    # gather subs per (group, schedule) bucket; key = (stages, late,
    # out_rate, nco_fs) so strict-reference orphans (full-rate NCO modulus)
    # never share a bucket with properly-matched channels
    per_group: dict[int | None, dict[tuple[int, int, int, int], list[SubPlan]]] = {}
    for idx, sub in enumerate(cfg.vfos):
        gidx, plan, stages, late = _plan_sub(cfg, sub, idx, mains)
        if gidx is None and strict_reference and mains:
            # the reference pushes unmatched subs into main group 0 with
            # raw-stream parameters (mainwindow.cpp:175-226): _plan_sub
            # already computed those (main_mixer=0, main_out=Fs); keep the
            # full-rate oscillator modulus so the phase advances by
            # mixer_freq per group-rate sample, like the reference's
            # Oscillator(Fs, mixer) ticked per input sample
            warnings.warn(
                f"vfo {sub.topic!r} matches no main VFO; strict_reference "
                f"reproduces the reference's misprocessing through main "
                f"group 0 (mainwindow.cpp:225)",
                stacklevel=2,
            )
            per_group.setdefault(0, {}).setdefault(
                (stages, late, plan.out_rate, fs), []
            ).append(plan)
            continue
        if gidx is None and strict_reference:
            # no main VFOs at all: the reference never processes subs then
            # (sdrj fans buffers out to main VFOs only, sdrj.cpp:288-294)
            warnings.warn(
                f"vfo {sub.topic!r}: no main VFOs; the reference would "
                f"never process this channel — dropping it "
                f"(strict_reference)",
                stacklevel=2,
            )
            continue
        if gidx is None:
            warnings.warn(
                f"vfo {sub.topic!r} matches no main VFO; planning it as a "
                f"direct-from-input channel at the rate its parameters "
                f"assume (the reference would misprocess it through main "
                f"group 0 — use strict_reference=True to reproduce that; "
                f"see PARITY.md)",
                stacklevel=2,
            )
        per_group.setdefault(gidx, {}).setdefault(
            (stages, late, plan.out_rate, 0), []
        ).append(plan)

    def _buckets(d):
        return tuple(
            BucketPlan(
                stages=k[0], late_factor=k[1], out_rate=k[2],
                nco_fs=k[3], subs=tuple(v),
            )
            for k, v in sorted(d.items())
        )

    groups: list[GroupPlan] = []
    for g in mains:
        groups.append(
            dataclasses.replace(g, buckets=_buckets(per_group.get(g.index, {})))
        )

    if None in per_group:
        groups.append(
            GroupPlan(
                index=len(mains),
                frequency=0,
                mixer_freq=0,
                out_rate=fs,
                stages=0,
                buckets=_buckets(per_group[None]),
                direct=True,
            )
        )

    plan = ReceiverPlan(
        fs=fs,
        center_frequency=cfg.center_frequency,
        dc_correct=cfg.correct_dc_bias,
        zmq_address=cfg.zmq_address,
        mix_offset=cfg.mix_offset,
        bufsplit=bufsplit,
        block_samples=block_samples,
        groups=tuple(groups),
    )
    div = plan.block_divisor()
    if plan.block_samples % div:
        raise ValueError(
            f"ingest block of {plan.block_samples} samples is not a multiple of "
            f"the chain divisor {div}"
        )
    return plan
