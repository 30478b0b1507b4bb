"""The plain reference receiver: u8 dongle bytes in, int16 USB audio out.

It builds its own plan from a configuration file's numbers and runs every
channel on its own, one stage after the other, in float64 (plain PyTorch on
any device):

  x = u8 - 127                          the dongle's value mapping
  m[n] = (1 - a) m[n-1] + a x[n], y = x - m      DC removal, a = 1e-6
  group: y e^{j 2 pi ((f_g n) mod fs) / fs}, then /2 half-band stages
  channel: the same mix at the group rate, then its /2 half-band stages
  late /5 or /6 low-pass (a leading zero tap: one sample of extra delay)
  USB: I delayed by 62 minus the 125-tap Hilbert of Q
  audio low-pass when the channel has a filter bandwidth (a leading zero tap)
  int16: round half to even of usb * gain * 32768, saturated

Decimating filters keep the samples at multiples of their factor, counted
from the stream's first sample, and every mixer's phase is counted from
there too.  The stream is a recording of whole blocks played in a cycle, so
the DC mean at any block's start has a closed form (:meth:`Reference.dc_before`);
the filters' state is rebuilt by running the blocks before the compared one
from zero, which the filters forget within their extent
(:func:`Chain.memory`).

``precision="tf32"`` is the control: the same chain in float32 with every
filter's operands rounded to TF32 (10-bit mantissa), as a tensor-core
convolution computes.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from . import design

__all__ = ["Chain", "mains", "plan", "Reference", "DC_ALPHA"]

#: SDRReceiver's DC tracking coefficient (sdrj.cpp).
DC_ALPHA = 1e-6
_DC_CHUNK = 4096


def _log2_exact(num: int, den: int, what: str) -> int:
    if num % den:
        raise ValueError(f"{what}: {num}/{den} is not an integer")
    q = num // den
    if q <= 0 or q & (q - 1):
        raise ValueError(f"{what}: ratio {q} is not a power of two")
    return q.bit_length() - 1


@dataclasses.dataclass(frozen=True)
class Chain:
    """One channel's path from the input stream to its audio."""

    topic: str
    gain: float  # the ini's gain / 100
    out_rate: int
    group: int | None  # its main VFO's position; None: it runs on the input stream
    group_mixer: int | None  # Hz
    group_stages: int
    mixer: int  # Hz at the group rate
    mix_fs: int  # the group rate
    stages: int
    late: int  # 1, 5 or 6
    late_taps: np.ndarray | None
    audio_taps: np.ndarray | None

    @property
    def decimation(self) -> int:
        """Input samples per audio sample."""
        return (1 << (self.group_stages + self.stages)) * self.late

    def memory(self) -> int:
        """Input samples the chain's filters remember."""
        hb = len(design.HALF_BAND) - 1
        mem = hb * ((1 << self.group_stages) - 1)
        mem += hb * ((1 << (self.group_stages + self.stages)) - (1 << self.group_stages))
        pre = 1 << (self.group_stages + self.stages)
        if self.late_taps is not None:
            mem += (len(self.late_taps) - 1) * pre
        tail = len(design.hilbert()) - 1
        if self.audio_taps is not None:
            tail += len(self.audio_taps) - 1
        return mem + tail * self.decimation


def mains(cfg: dict) -> list[tuple[int, int, int, int]]:
    """Each main VFO's ``(frequency, out_rate, mixer, /2 stages)``."""
    fs = int(cfg["sample_rate"])
    out = []
    for i, m in enumerate(cfg["main_vfos"]):
        rate = int(m["out_rate"])
        stages = 0 if fs // rate == 1 else _log2_exact(fs, rate, f"main vfo {i + 1}")
        out.append((int(m["frequency"]), rate, int(cfg["center_frequency"]) - int(m["frequency"]),
                     stages))
    return out


def plan(cfg: dict) -> tuple[int, bool, list[Chain]]:
    """``(fs, dc_correct, chains in the configuration's order)`` from a
    configuration file: SDRReceiver's planning rules (mainwindow.cpp)."""
    fs = int(cfg["sample_rate"])
    if fs not in (288000, 1536000, 1920000):
        raise ValueError(f"sample_rate {fs} unsupported")
    center = int(cfg["center_frequency"])
    mix_offset = int(cfg.get("mix_offset", 0))
    groups = mains(cfg)
    chains = []
    for v in cfg["vfos"]:
        freq = int(v["frequency"]) + mix_offset
        out = int(v.get("out_rate", 0)) or {600: 12000, 1200: 24000}.get(
            int(v.get("data_rate", 0)), 48000)
        group = next((i for i, m in enumerate(groups) if abs(m[0] - freq) < m[1]), None)
        if group is None:  # no main VFO: the channel runs on the input stream
            main_out, main_mixer, gstages = fs, 0, 0
        else:
            _, main_out, main_mixer, gstages = groups[group]
        if main_out // 48000 in (5, 6):
            late = main_out // 48000
            stages = _log2_exact(main_out, late * out, f"vfo {v['topic']}")
        else:
            late = 1
            stages = _log2_exact(fs, out, v["topic"]) - _log2_exact(fs, main_out, v["topic"])
        late_taps = None
        if late > 1:
            late_taps = np.concatenate([[np.float32(0.0)], design.low_pass(
                2.0, float(out * late), out / 2.0, out / float(late - 1))]).astype(np.float32)
        bw = int(v.get("filter_bandwidth", 0))
        audio_taps = None
        if bw > 0:
            audio_taps = np.concatenate([[np.float32(0.0)], design.low_pass(
                2.0, float(out), float(bw), bw / 4.0)]).astype(np.float32)
        chains.append(Chain(
            topic=v["topic"], gain=float(v["gain"]) / 100.0, out_rate=out,
            group=group, group_mixer=None if group is None else main_mixer, group_stages=gstages,
            mixer=(center - main_mixer) - freq, mix_fs=main_out, stages=stages, late=late,
            late_taps=late_taps, audio_taps=audio_taps,
        ))
    return fs, bool(cfg.get("correct_dc_bias", False)), chains


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits, ties to even)."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


class Reference:
    """The reference receiver over a recording ``pool`` (u8 ``[P, 2T]``,
    block ``P`` of the stream is ``pool[P % len(pool)]``)."""

    def __init__(self, cfg: dict, pool: np.ndarray, device: str | torch.device = "cpu",
                 precision: str = "float64"):
        if precision not in ("float64", "tf32"):
            raise ValueError(f"precision {precision!r}")
        self.fs, self.dc, self.chains = plan(cfg)
        self.pool = pool
        self.block = pool.shape[1] // 2
        self.device = torch.device(device)
        self.tf32 = precision == "tf32"
        self.dtype = torch.float32 if self.tf32 else torch.float64
        div = max(c.decimation for c in self.chains)
        if self.block % div:
            raise ValueError(f"block {self.block} is not a multiple of {div}")
        self.warm = max(1, math.ceil(max(c.memory() for c in self.chains) / self.block))
        self._ends = None  # each pool block's zero-start DC mean at its end

    # ---------------------------------------------------------------- input
    def _x(self, blocks: list[int]) -> torch.Tensor:
        """Stream blocks -> planar ``[2, n]`` values u8 - 127."""
        raw = np.concatenate([self.pool[b % len(self.pool)] for b in blocks])
        x = torch.as_tensor(raw, device=self.device).to(self.dtype) - 127.0
        return x.view(-1, 2).t().contiguous()

    def _ema(self, x: torch.Tensor, m0: torch.Tensor) -> torch.Tensor:
        """The DC mean after every sample of planar ``x [2, n]``, from the
        mean ``m0 [2]`` before it: a cumulative sum inside chunks and across
        them, scaled so that no power of ``a`` leaves [1/30, 30]."""
        n = x.shape[1]
        b = _DC_CHUNK
        nc = -(-n // b)
        la = math.log1p(-DC_ALPHA)
        xb = F.pad(x, (0, nc * b - n)).view(2, nc, b)
        k = torch.arange(b, device=x.device, dtype=torch.float64)
        up, down = torch.exp(-k * la).to(x.dtype), torch.exp(k * la).to(x.dtype)
        v = torch.cumsum(xb * up, dim=-1) * down * DC_ALPHA  # zero-start mean in a chunk
        j = torch.arange(nc, device=x.device, dtype=torch.float64)
        # carry into chunk j: a^(Bj) (m0 + sum_{t<j} a^(-B(t+1)) end_t)
        ends = v[..., -1] * torch.exp(-(j + 1) * b * la).to(x.dtype)
        acc = torch.cumsum(ends, dim=-1) - ends
        carry = torch.exp(j * b * la).to(x.dtype) * (m0[:, None] + acc)
        m = carry[..., None] * (down * math.exp(la)) + v
        return m.reshape(2, -1)[:, :n]

    def dc_before(self, n_block: int) -> torch.Tensor:
        """The DC mean ``[2]`` before stream block ``n_block``, in float64."""
        p = len(self.pool)
        la = math.log1p(-DC_ALPHA)
        if self._ends is None:
            w = DC_ALPHA * torch.exp(torch.arange(self.block - 1, -1, -1, device=self.device,
                                                  dtype=torch.float64) * la)
            ends = []
            for j in range(p):
                x = torch.as_tensor(self.pool[j], device=self.device).to(torch.float64) - 127.0
                ends.append(x.view(-1, 2).t() @ w)
            self._ends = torch.stack(ends)  # [P, 2]
        at = math.exp(self.block * la)
        cycle = sum(self._ends[j] * at ** (p - 1 - j) for j in range(p))
        q, r = divmod(n_block, p)
        m = cycle * ((1.0 - at ** (p * q)) / (1.0 - at ** p))
        for j in range(r):
            m = at * m + self._ends[j]
        return m

    # ---------------------------------------------------------------- stages
    def _fir(self, x: torch.Tensor, taps: np.ndarray, stride: int = 1) -> torch.Tensor:
        """Causal FIR from zero history on planar ``x [k, n]``, keeping
        outputs 0, stride, 2 stride, ..."""
        c = torch.tensor(np.ascontiguousarray(taps[::-1]), device=x.device).to(x.dtype)
        xp = F.pad(x, (len(taps) - 1, 0))
        if self.tf32:
            xp, c = _tf32(xp), _tf32(c)
        return F.conv1d(xp[:, None, :], c[None, None, :], stride=stride)[:, 0, :]

    def _mix(self, x: torch.Tensor, f: int, fs: int, start: int) -> torch.Tensor:
        """``x [2, n]`` times e^{j 2 pi ((f i) mod fs) / fs} at absolute
        sample indices ``i = start ..``."""
        i = torch.arange(x.shape[1], device=x.device, dtype=torch.int64) + start % fs
        ph = (f % fs) * (i % fs) % fs
        theta = ph.to(torch.float64) * (2.0 * math.pi / fs)
        c, s = torch.cos(theta).to(x.dtype), torch.sin(theta).to(x.dtype)
        return torch.stack([x[0] * c - x[1] * s, x[0] * s + x[1] * c])

    def _halfbands(self, x: torch.Tensor, stages: int) -> torch.Tensor:
        for _ in range(stages):
            x = self._fir(x, design.HALF_BAND, 2)
        return x

    def _channel(self, c: Chain, y: torch.Tensor, start: int) -> torch.Tensor:
        """Post-DC stream ``y [2, n]`` from absolute sample ``start`` ->
        the channel's int16 audio."""
        if c.group_mixer is not None:
            y = self._halfbands(self._mix(y, c.group_mixer, self.fs, start), c.group_stages)
        z = self._mix(y, c.mixer, c.mix_fs, start >> c.group_stages)
        z = self._halfbands(z, c.stages)
        if c.late_taps is not None:
            z = self._fir(z, c.late_taps, c.late)
        hil = self._fir(z[1:], design.hilbert())[0]
        d = design.HILBERT_DELAY
        usb = F.pad(z[0], (d, 0))[: z.shape[1]] - hil
        if c.audio_taps is not None:
            usb = self._fir(usb[None], c.audio_taps)[0]
        gain = torch.tensor(c.gain * 32768.0, dtype=self.dtype) if not self.tf32 else \
            torch.tensor(np.float32(c.gain) * np.float32(32768.0))
        return torch.clamp(torch.round(usb * gain.to(usb.device)), -32768, 32767).to(torch.int16)

    def audio(self, n_block: int) -> dict[str, np.ndarray]:
        """Stream block ``n_block``'s int16 audio per topic."""
        first = max(0, n_block - self.warm)
        blocks = list(range(first, n_block + 1))
        x = self._x(blocks)
        if self.dc:
            m0 = self.dc_before(first).to(self.dtype)
            x = x - self._ema(x, m0)
        start = first * self.block
        out = {}
        for c in self.chains:
            a = self._channel(c, x, start)
            keep = self.block // c.decimation
            out[c.topic] = a[-keep:].cpu().numpy()
        return out
