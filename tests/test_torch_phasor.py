"""The redesigned kernels' arithmetic, held on the CPU.

``csrc/mix_cascade.cu`` computes the NCO phasor from two tables and a
second-order correction instead of a double ``sincos``; ``csrc/dc_ingest.cu``
carries the DC mean across tiles by a chained scan with decoupled look-back
over a table of decay powers.  Neither kernel runs here (no card, no nvcc):
these tests hold the formulas they implement, written in torch and numpy,
against float64 ``cos``/``sin``, the previous formula, the JAX package's mix
and cascade (jnp and Pallas interpret), and the DC plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdrreceiver_tpu.kernels import halfband as jhalfband
from sdrreceiver_tpu.kernels import nco as jnco
from sdrreceiver_tpu.pallas.frontend import MixCascadeKernel
from sdrreceiver_tpu_torch.cuda import dckernel, frontend
from sdrreceiver_tpu_torch.cuda.frontend import MixCascade
from sdrreceiver_tpu_torch.flagship import benchmark_config
from sdrreceiver_tpu_torch.graph.plan import build_plan
from sdrreceiver_tpu_torch.kernels import dc, nco

# six xdist workers share the machine's cores: a few torch threads each
torch.set_num_threads(2)

ULP1 = 2.0**-52  # one double ulp of 1


# -------------------------------------------------------------- (a) phasor
@pytest.mark.parametrize("fs", [1_536_000, 1_920_000, 384_000, 240_000, 192_000])
def test_table_phasor_matches_cos_sin_at_every_phase(rng, fs):
    """The kernel's phasor (a warp's Thi * Tlo, a lane factor, exp(j r))
    against float64 cos/sin of the float32 theta, over every phase
    numerator m in [0, fs), each split at a random lane offset d: within 4
    double ulps of 1."""
    m = np.arange(fs)
    d = rng.integers(0, fs, fs)
    mw = (m - d) % fs
    lane = frontend.lane_factors(d, fs)[m, (mw + d >= fs).astype(int)]
    tables = tuple(torch.from_numpy(t) for t in frontend.phasor_tables(fs))
    cos, sin = frontend.phasor_plain(torch.from_numpy(mw), torch.from_numpy(d),
                                     torch.from_numpy(lane), fs, tables)
    theta = nco.theta_planar(torch.zeros(1, dtype=torch.int64), torch.ones(1, dtype=torch.int64),
                             fs, fs)[0].double().numpy()
    assert np.abs(cos.numpy() - np.cos(theta)).max() <= 4 * ULP1
    assert np.abs(sin.numpy() - np.sin(theta)).max() <= 4 * ULP1


# ---------------------------------------------- (b) against the old formula
def _old_mix_cascade_plain(phase, xr, xi, depths, fs, f_mod):
    """The previous plain version: a double sin/cos of the float32 theta."""
    theta = nco.theta_planar(phase, f_mod, fs, xr.shape[-1]).double()
    cos, sin = torch.cos(theta), torch.sin(theta)
    xr, xi = xr.double(), xi.double()
    zr = (xr * cos - xi * sin).float().double()
    zi = (xr * sin + xi * cos).float().double()
    ys = [None] * len(depths)
    for d in sorted(set(depths)):
        idx = [c for c, dc_ in enumerate(depths) if dc_ == d]
        sel = torch.tensor(idx)
        hc = torch.tensor(frontend.composite_taps(d)[::-1].copy()).double()
        z = torch.stack([zr[sel], zi[sel]])
        y = torch.nn.functional.conv1d(
            torch.nn.functional.pad(z, (len(hc) - 1, 0)),
            hc.expand(len(idx), 1, -1).contiguous(), stride=1 << d, groups=len(idx),
        ).float()
        for k, c in enumerate(idx):
            ys[c] = (y[0, k], y[1, k])
    return torch.cat([y[0] for y in ys]), torch.cat([y[1] for y in ys])


def _sites():
    """(depths, fs, freqs, per-channel input): the four flagship sites and
    the per-channel-input depth-7 case chip_smoke.py runs."""
    plan = build_plan(benchmark_config())
    g0, g1 = plan.groups
    return {
        "merged": ([g0.stages, g1.stages], plan.fs, [g0.mixer_freq, g1.mixer_freq], False),
        "g0_b0": ([g0.buckets[0].stages], g0.out_rate, g0.buckets[0].mixer_freqs(), False),
        "g0_b1": ([g0.buckets[1].stages] * 11, g0.out_rate, g0.buckets[1].mixer_freqs(), False),
        "g1_b0": ([g1.buckets[0].stages] * 15, g1.out_rate, g1.buckets[0].mixer_freqs(), False),
        "per_channel_d7": ([7, 3], plan.fs, [484000, -496000], True),
    }


@pytest.mark.parametrize("site", ["merged", "g0_b0", "g0_b1", "g1_b0", "per_channel_d7"])
def test_table_phasor_keeps_the_outputs_of_sincos(rng, site):
    """The new plain version against the old formula: float32 outputs equal
    but for rounding ties, at a rate below 1e-6."""
    depths, fs, freqs, per_channel = _sites()[site]
    t_len = 1 << 14
    mc = MixCascade(depths, fs, freqs, "cpu")
    x = rng.uniform(-128, 128, (2, len(depths) if per_channel else 1, t_len)).astype(np.float32)
    phase = torch.from_numpy(rng.integers(0, fs, len(depths)))
    new = mc(phase, torch.from_numpy(x[0]), torch.from_numpy(x[1]))
    old = _old_mix_cascade_plain(phase, torch.from_numpy(x[0]), torch.from_numpy(x[1]),
                                 depths, fs, mc.f_mod)
    differ = sum(int((a != b).sum()) for a, b in zip(new, old))
    assert differ / (2 * new[0].numel()) < 1e-6


# ------------------------------------------- (c) against JAX, carried phase
@pytest.mark.parametrize("site", ["merged", "g0_b1"])
def test_mix_cascade_plain_streams_like_jax(rng, site):
    """Three consecutive blocks with the phase carried and a warm-up prefix
    (as the receiver feeds the kernel) against the JAX package's jnp mix +
    half-band cascade with carried histories, and against its Pallas kernel
    (interpret) on the same prefixed input; atol 2e-3 for inputs in +-128."""
    depths, fs, freqs, _ = _sites()[site]
    if site == "g0_b1":
        depths, freqs = depths[:3], freqs[:3]
    c, dmax = len(depths), max(depths)
    warm = frontend.warmup_len(dmax)
    t_all = 256 * 32
    block = t_all - warm
    mc = MixCascade(depths, fs, freqs, "cpu")
    multi = len(set(depths)) > 1
    kern = MixCascadeKernel(c, depths if multi else depths[0], fs, np.asarray(freqs, np.int64),
                            t_all, interpret=True, shared_input=True)
    jstate = [jnco.nco_init([f], fs) for f in freqs]
    jhist = [jhalfband.cascade_init_planar(1, d) for d in depths]
    phase = torch.zeros(c, dtype=torch.int64)
    tail = np.zeros((2, warm), np.float32)
    for _ in range(3):
        x = rng.uniform(-128, 128, (2, block)).astype(np.float32)
        inp = np.concatenate([tail, x], axis=1)
        ph0 = frontend.phase_back(phase, mc.f_mod, fs, warm)
        yr, yi = mc(ph0, torch.from_numpy(inp[:1].copy()), torch.from_numpy(inp[1:].copy()))
        pr, pi = kern(jnp.asarray(ph0.numpy().astype(np.uint32)),
                      jnp.asarray(inp[:1]), jnp.asarray(inp[1:]))
        for ci, (ar, ai) in enumerate(zip(mc.split(yr, t_all), mc.split(yi, t_all))):
            d = depths[ci]
            ours = (ar.numpy()[warm >> d:], ai.numpy()[warm >> d:])
            if multi:  # JAX pads every channel to the widest output
                l_c = kern.lanes >> d
                pal = [np.asarray(p)[ci, :, :l_c].reshape(-1)[warm >> d:] for p in (pr, pi)]
            else:
                pal = [np.asarray(p)[ci][warm >> d:] for p in (pr, pi)]
            jstate[ci], z = jnco.mix_block_planar(jstate[ci], (jnp.asarray(x[0]), jnp.asarray(x[1])), fs)
            jhist[ci], y = jhalfband.cascade_apply_planar(jhist[ci], z, jhalfband.cascade_taps(1))
            for k in range(2):
                np.testing.assert_allclose(ours[k], np.asarray(y[k])[0], rtol=0, atol=2e-3)
                np.testing.assert_allclose(ours[k], pal[k], rtol=0, atol=2e-3)
        phase = (phase + mc.f_mod * block) % fs
        tail = inp[:, -warm:]


# --------------------------------------------------- (d) the decay powers
@pytest.mark.parametrize("alpha", [dc.DEFAULT_ALPHA, 1e-4])
@pytest.mark.parametrize("segment", ["a^n", "a^(tile j)"])
def test_decay_table_is_exp_log1p_rounded_once(alpha, segment):
    """Each entry of the kernel's table is exp(n log1p(-alpha)) in float64,
    rounded once to float32, at the exponent the kernel reads it for."""
    table = dckernel.decay_table(alpha)
    n_pow = dckernel.TILE + 1
    if segment == "a^n":
        n, got = np.arange(n_pow), table[:n_pow]
    else:
        n, got = dckernel.TILE * np.arange(dckernel.LOOK + 1), table[n_pow:]
    want = np.exp(n.astype(np.float64) * np.log1p(-alpha)).astype(np.float32)
    np.testing.assert_array_equal(got, want)


# ------------------------------------------ (e) the look-back carry algebra
def _lookback_model(mean, x, alpha):
    """numpy model of dc_ingest.cu's carry: tiles of ``dckernel.TILE``, the
    partial last one masked at its front; each tile's zero-carry aggregate
    E; tile k's incoming mean the sum of a^(tile l) E_(k-1-l) over its L =
    min(LOOK, k) predecessors plus a^(tile L) times the inclusive end value
    of tile k-1-L (the carried mean for k <= LOOK).  Complex float64."""
    t_len = x.size
    tile, look = dckernel.TILE, dckernel.LOOK
    n = -(-t_len // tile)
    pad = n * tile - t_len
    pw = dckernel.decay_table(alpha).astype(np.float64)
    pw_n, pw_tile = pw[: tile + 1], pw[tile + 1:]
    a = 1.0 - alpha  # inside a tile: the recurrence, in float64
    # full tiles in order; the last tile's valid samples at its end, behind
    # `pad` masked (zero) positions
    xs = np.concatenate([x[: (n - 1) * tile], np.zeros(pad, complex), x[(n - 1) * tile:]])
    xs = xs.reshape(n, tile)
    agg = np.zeros(n, complex)
    for k in range(n):
        m = 0j
        for v in xs[k]:
            m = a * m + alpha * v
        agg[k] = m
    inclusive, carry_in = np.zeros(n, complex), np.zeros(n, complex)
    for k in range(n):
        el = min(look, k)
        anchor = mean if k == el else inclusive[k - 1 - el]
        carry_in[k] = sum(pw_tile[l] * agg[k - 1 - l] for l in range(el)) + pw_tile[el] * anchor
        valid = tile - (pad if k == n - 1 else 0)
        inclusive[k] = pw_n[valid] * carry_in[k] + agg[k]
    y = np.zeros(n * tile, complex)
    for k in range(n):
        first = pad if k == n - 1 else 0
        m = 0j
        for p in range(tile):
            if p == first:
                m += carry_in[k]
            m = a * m + alpha * xs[k, p]
            y[k * tile + p] = xs[k, p] - m
    return inclusive[-1], np.concatenate([y[: (n - 1) * tile], y[(n - 1) * tile + pad:]])


@pytest.mark.parametrize("t_len", [1, 7, 300, 4096, 4224, 600_000])
def test_lookback_carry_matches_plain(rng, t_len):
    """The look-back combine over ragged T (one tile, a partial tile, more
    tiles than one window) against dc_ingest_plain, at the kernel's limits:
    y 1e-3 abs, new mean 1e-4 rel."""
    raw = rng.integers(0, 256, 2 * t_len).astype(np.uint8)
    raw[0::2] = np.clip(raw[0::2].astype(int) // 4 + 140, 0, 255)  # a DC offset on I
    mean = np.array([3.25, -1.5], np.float32)
    x = (raw[0::2].astype(np.float64) - 127.0) + 1j * (raw[1::2].astype(np.float64) - 127.0)
    new_mean, y = _lookback_model(complex(mean[0], mean[1]), x, dc.DEFAULT_ALPHA)
    pm, (pr, pi) = dckernel.dc_ingest_plain(torch.from_numpy(mean), torch.from_numpy(raw))
    np.testing.assert_allclose(y.real, pr.numpy(), rtol=0, atol=1e-3)
    np.testing.assert_allclose(y.imag, pi.numpy(), rtol=0, atol=1e-3)
    np.testing.assert_allclose([new_mean.real, new_mean.imag], pm.numpy(), rtol=1e-4, atol=0)
