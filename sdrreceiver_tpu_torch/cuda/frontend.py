"""Fused NCO mix + half-band cascade: the ``csrc/mix_cascade.cu`` wrapper.

Counterpart of ``sdrreceiver_tpu/pallas/frontend.py``.  For C channels over
one shared input (or one input row per channel): an exact integer-phase NCO
mix, then the d-stage /2 half-band cascade collapsed into one composite FIR
(:func:`composite_taps`) evaluated at stride 2^d.  Each channel has its own
depth, so one kernel serves the merged group front (depths [2, 3]) and the
sub-VFO buckets alike — the JAX package's channel-loop and grid kernels
compute this one function.

The kernel is stateless: the caller prepends :func:`warmup_len` samples of
the stream's past and drops ``warmup_len >> d`` outputs; a zero-state FIR
forgets its start after its extent, so the kept outputs are the streamed
ones.  The JAX package pads that warm-up for TPU tiling
(``pick_warmup``); any warm-up of at least ``warmup_len`` gives the same
outputs, and this port uses ``warmup_len`` itself.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

from ..kernels import design, nco
from . import build

__all__ = [
    "composite_taps",
    "warmup_len",
    "phase_back",
    "phasor_tables",
    "lane_factors",
    "lane_table",
    "phasor_plain",
    "mix_cascade_plain",
    "MixCascade",
]

LANES = 256  # warm-up granule (the JAX package's row width)
MAX_DEPTH = 7
PHASOR_BITS = 11  # K: Tlo has 2^K entries, Thi ceil(fs / 2^K)
FS_LIMIT = 1 << 22  # m * f32(2 pi / fs) is exact in double below it


def composite_taps(stages: int, taps=None) -> np.ndarray:
    """The d-stage /2 cascade as ONE input-rate FIR (noble identity):
    ``hc = h * (h up 2) * (h up 4) * ...``, length ``10*(2^d - 1) + 1``;
    the cascade output is ``y[m] = sum_q hc[q] x[2^d m - q]``.  float64
    accumulation, f32 cast at the end."""
    h = np.asarray(
        design.half_band(11) if taps is None else taps, dtype=np.float64
    )
    hc = np.array([1.0])
    for s in range(stages):
        up = np.zeros((len(h) - 1) * (1 << s) + 1)
        up[:: 1 << s] = h
        hc = np.convolve(hc, up)
    return hc.astype(np.float32)


def warmup_len(stages: int) -> int:
    """Input-halo length that washes out a zero-state composite cascade,
    rounded up to whole 256-sample rows.  The filter extent is
    ``10*(2^d - 1)``; an extra ``10*2^(d-1)`` keeps the LAST stage's final
    10 input samples exact too, which is what lets per-stage histories be
    re-derived from a stream tail (halfband.cascade_tails_from_tail)."""
    need = 10 * ((1 << stages) - 1) + 10 * (1 << max(stages - 1, 0))
    return max(LANES, -(-need // LANES) * LANES)


def phase_back(
    phase: torch.Tensor, f_mod: torch.Tensor, fs: int, n_back: int
) -> torch.Tensor:
    """Phase ``n_back`` samples BEFORE ``phase`` (int64 ``[C]``, exact):
    what the kernel wants when its input is prefixed with ``n_back``
    warm-up samples."""
    return (phase + fs - f_mod * n_back % fs) % fs


def _angle_step(fs: int) -> float:
    """F = f32(2 pi / fs), the NCO's angle per unit of phase numerator."""
    return float(np.float32(2.0 * np.pi / fs))


@functools.cache
def phasor_tables(fs: int) -> tuple[np.ndarray, np.ndarray]:
    """``(Thi, Tlo)``, float64 ``(re, im)`` pairs: ``Thi[i] = exp(j F i
    2^K)`` for ``i < ceil(fs / 2^K)``, ``Tlo[i] = exp(j F i)`` for ``i <
    2^K``, with ``F = f32(2 pi / fs)`` and ``K =`` :data:`PHASOR_BITS`.
    Every argument ``F i 2^K`` and ``F i`` is exact in double."""
    if not 0 < fs < FS_LIMIT:
        raise ValueError(f"sample rate {fs} outside (0, {FS_LIMIT})")
    f = _angle_step(fs)
    hi = f * np.arange(-(-fs // (1 << PHASOR_BITS)), dtype=np.float64) * (1 << PHASOR_BITS)
    lo = f * np.arange(1 << PHASOR_BITS, dtype=np.float64)
    return tuple(np.stack([np.cos(a), np.sin(a)], axis=-1) for a in (hi, lo))


def lane_factors(d, fs: int) -> np.ndarray:
    """``exp(j F d)`` and ``exp(j F (d - fs))``, float64 ``[..., 2, 2]``
    (unwrapped, wrapped; ``(re, im)``) for integer ``d`` in ``[0, fs)``:
    both arguments are exact in double."""
    f = _angle_step(fs)
    d = np.asarray(d, np.int64)
    ang = f * np.stack([d, d - fs], axis=-1).astype(np.float64)
    return np.stack([np.cos(ang), np.sin(ang)], axis=-1)


def lane_table(f_mod, fs: int) -> np.ndarray:
    """:func:`lane_factors` of each channel's lane offsets ``d = f * lane
    mod fs``, lane 0..31 of a warp: float64 ``[C, 32, 2, 2]``."""
    return lane_factors(np.asarray(f_mod, np.int64)[:, None] * np.arange(32) % fs, fs)


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def phasor_plain(
    mw: torch.Tensor,
    d: torch.Tensor,
    lane: torch.Tensor,
    fs: int,
    tables: tuple[torch.Tensor, torch.Tensor],
) -> tuple[torch.Tensor, torch.Tensor]:
    """``exp(j theta)`` as float64 ``(cos, sin)`` for the phase numerator
    ``m = (mw + d) mod fs`` (int64 ``mw``, ``d`` in ``[0, fs)``), ``theta =
    f32(m) * f32(2 pi / fs)`` as in kernels/nco, the kernel's way, operation
    for operation: ``theta_d = m F`` is exact in double, ``theta_f =
    f32(theta_d)``, ``r = theta_f - theta_d`` exact and ``|r| <= 2^-22``, and
    ``exp(j theta_f) = (Thi[mw >> K] Tlo[mw mod 2^K]) lane ((1 - r r / 2) +
    j r)``.  ``tables`` is :func:`phasor_tables` on the device; ``lane`` the
    :func:`lane_factors` entry ``[..., 2]`` of ``d``, wrapped where ``mw + d
    >= fs``."""
    thi, tlo = tables
    f = _angle_step(fs)
    th_w, th_d = mw.double() * f, d.double() * f
    theta_d = torch.where(mw + d >= fs, th_w + th_d - fs * f, th_w + th_d)
    r = theta_d.float().double() - theta_d
    h, lo = thi[mw >> PHASOR_BITS], tlo[mw & ((1 << PHASOR_BITS) - 1)]
    u = _cmul(h[..., 0], h[..., 1], lo[..., 0], lo[..., 1])
    pm = _cmul(*u, lane[..., 0], lane[..., 1])
    return _cmul(*pm, 1.0 - r * r * 0.5, r)


def mix_cascade_plain(
    phase: torch.Tensor,
    xr: torch.Tensor,
    xi: torch.Tensor,
    depths: Sequence[int],
    fs: int,
    f_mod: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: exact-phase mix then a zero-history
    strided conv with :func:`composite_taps` per depth.

    ``phase``, ``f_mod`` int64 ``[C]``; ``xr``, ``xi`` f32 ``[1, T]``
    (shared) or ``[C, T]``.  Returns flat channel-major ``(yr, yi)``,
    channel c's ``T >> depths[c]`` outputs after those of the channels
    before it.

    Rounding points, shared with the kernel: theta in float32 exactly as
    kernels/nco (the JAX package's phase semantics); its phasor by
    :func:`phasor_plain`, decomposed as the kernel's warps see it (lane =
    ``(n + halo) mod 32`` of sample n, ``halo`` the kernel's input halo of
    ``10 (2^max(depths) - 1)`` samples), and the mix in float64, one
    rounding per operation, the mix then rounded once to float32; the FIR
    sums the exact float64 products of float32 taps and mixed samples and
    rounds once.  Both sides are then correctly
    rounded to within ~1e-16, so they agree bit for bit whatever their
    summation order, save for rare rounding ties.  With float32 sums in two
    orders, ~1% of int16 audio samples at rms ~10^4 would differ by one LSB
    between kernel and plain version."""
    dev = xr.device
    thi, tlo = (torch.as_tensor(t, device=dev) for t in phasor_tables(fs))
    lanes = torch.as_tensor(lane_table(f_mod.cpu().numpy(), fs), device=dev)
    halo = 10 * ((1 << max(depths)) - 1)
    n = torch.arange(xr.shape[-1], dtype=torch.int64, device=dev)
    lane = (n + halo) % 32
    mw = (phase[:, None] + f_mod[:, None] * (n - lane) % fs) % fs
    d = f_mod[:, None] * lane % fs
    # lanes[c, lane, wrap] as [C, T, 2]
    sel = (lane * 2 + (mw + d >= fs)).reshape(len(depths), -1, 1).expand(-1, -1, 2)
    lf = torch.gather(lanes.reshape(len(depths), 64, 2), 1, sel)
    cos, sin = phasor_plain(mw, d, lf, fs, (thi, tlo))
    xr, xi = xr.double(), xi.double()
    zr, zi = (v.float().double() for v in _cmul(xr, xi, cos, sin))
    ys: list = [None] * len(depths)
    for d in sorted(set(depths)):
        idx = [c for c, dc in enumerate(depths) if dc == d]
        sel = torch.tensor(idx, device=dev)
        hc = torch.tensor(composite_taps(d)[::-1].copy(), device=dev).double()
        z = torch.stack([zr[sel], zi[sel]])  # [2, Cd, T]
        y = torch.nn.functional.conv1d(
            torch.nn.functional.pad(z, (len(hc) - 1, 0)),
            hc.expand(len(idx), 1, -1).contiguous(),
            stride=1 << d,
            groups=len(idx),
        ).float()
        for k, c in enumerate(idx):
            ys[c] = (y[0, k], y[1, k])
    return torch.cat([y[0] for y in ys]), torch.cat([y[1] for y in ys])


class MixCascade(torch.nn.Module):
    """One batch of channels: ``(phase [C], xr, xi) -> (yr, yi)``.

    ``depths`` per channel (each 0..7), mixer ``freqs_hz`` at stream rate
    ``fs``.  ``phase`` is int64 ``[C]`` at the FIRST input sample; ``xr``,
    ``xi`` are f32 ``[1, T]`` (shared input) or ``[C, T]``, T a multiple of
    ``2^max(depths)``.  Output as :func:`mix_cascade_plain`; :meth:`split`
    cuts it per channel.

    CPU tensors take the plain version.  CUDA tensors launch the kernel or
    raise.  ``launches`` counts kernel launches."""

    def __init__(
        self,
        depths: Sequence[int],
        fs: int,
        freqs_hz,
        device: torch.device | str,
    ):
        super().__init__()
        self.depths = [int(d) for d in depths]
        if not all(0 <= d <= MAX_DEPTH for d in self.depths):
            raise ValueError(f"depths must be in 0..{MAX_DEPTH}: {self.depths}")
        f = np.mod(np.asarray(freqs_hz, dtype=np.int64), fs)
        if f.shape != (len(self.depths),):
            raise ValueError(f"freqs shape {f.shape} != ({len(self.depths)},)")
        self.fs = int(fs)
        self.dmax = max(self.depths)
        taps = np.zeros((len(self.depths), len(composite_taps(self.dmax))), np.float32)
        for c, d in enumerate(self.depths):
            hc = composite_taps(d)
            taps[c, : len(hc)] = hc
        self.register_buffer("f_mod", torch.tensor(f, device=device))
        self.register_buffer(
            "depth", torch.tensor(self.depths, dtype=torch.int32, device=device)
        )
        # float64 (exact float32 values): the kernel converts none per tap
        self.register_buffer("taps", torch.tensor(taps, dtype=torch.float64, device=device))
        thi, tlo = phasor_tables(self.fs)
        self.register_buffer("thi", torch.tensor(thi, device=device))
        self.register_buffer("tlo", torch.tensor(tlo, device=device))
        self.register_buffer("lanes", torch.tensor(lane_table(f, self.fs), device=device))
        self.launches = 0

    @property
    def channels(self) -> int:
        return len(self.depths)

    def out_lens(self, t_len: int) -> list[int]:
        return [t_len >> d for d in self.depths]

    def split(self, y: torch.Tensor, t_len: int) -> tuple[torch.Tensor, ...]:
        """Flat output -> one ``[T >> d_c]`` view per channel."""
        return torch.split(y, self.out_lens(t_len))

    def plain(self, phase, xr, xi):
        return mix_cascade_plain(phase, xr, xi, self.depths, self.fs, self.f_mod)

    def forward(self, phase: torch.Tensor, xr: torch.Tensor, xi: torch.Tensor):
        if xr.device.type == "cpu":
            return self.plain(phase, xr, xi)
        if xr.device.type != "cuda":
            raise ValueError(f"MixCascade: unsupported device {xr.device}")
        c = self.channels
        dev = self.taps.device
        for name, t in (("xr", xr), ("xi", xi)):
            if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
                raise ValueError(f"MixCascade: {name} must be contiguous float32 on {dev}")
        if xr.dim() != 2 or xr.shape != xi.shape or xr.shape[0] not in (1, c):
            raise ValueError(
                f"MixCascade: inputs must be [1 or {c}, T], got "
                f"{tuple(xr.shape)} and {tuple(xi.shape)}"
            )
        if (
            phase.device != dev
            or phase.dtype != torch.int64
            or phase.shape != (c,)
            or not phase.is_contiguous()
        ):
            raise ValueError(f"MixCascade: phase must be contiguous int64 [{c}] on {dev}")
        t_len = xr.shape[1]
        if t_len % (1 << self.dmax):
            raise ValueError(f"MixCascade: T={t_len} not a multiple of 2^{self.dmax}")
        n_out = sum(self.out_lens(t_len))
        yr = torch.empty(n_out, dtype=torch.float32, device=dev)
        yi = torch.empty(n_out, dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = build.library().mix_cascade_launch(
                xr.data_ptr(), xi.data_ptr(), 0 if xr.shape[0] == 1 else t_len,
                t_len, phase.data_ptr(), self.f_mod.data_ptr(),
                self.depth.data_ptr(), self.fs,
                _angle_step(self.fs), self.thi.data_ptr(),
                self.tlo.data_ptr(), PHASOR_BITS, self.lanes.data_ptr(), self.taps.data_ptr(),
                self.taps.shape[1], yr.data_ptr(), yi.data_ptr(), c, self.dmax,
                stream,
            )
        build.check(err, "mix_cascade_launch")
        self.launches += 1
        return yr, yi
