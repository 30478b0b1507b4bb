"""The PyTorch port's host modules and DSP functions vs the JAX package.

Each comparison takes the same numpy-seeded inputs through the JAX function
and its counterpart in ``sdrreceiver_tpu_torch``; the tolerance is stated
at each assert.  Runs on the CPU.
"""

import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
import test_pallas
from sdrreceiver_tpu.graph import config as jconfig
from sdrreceiver_tpu.graph import plan as jplan
from sdrreceiver_tpu.io import iqfile as jiqfile
from sdrreceiver_tpu.kernels import dc as jdc
from sdrreceiver_tpu.kernels import design as jdesign
from sdrreceiver_tpu.kernels import fir as jfir
from sdrreceiver_tpu.kernels import halfband as jhalfband
from sdrreceiver_tpu.kernels import ingest as jingest
from sdrreceiver_tpu.kernels import nco as jnco
from sdrreceiver_tpu.kernels import polyphase as jpolyphase
from sdrreceiver_tpu.kernels import usbdemod as jusb
from sdrreceiver_tpu_torch import flagship
from sdrreceiver_tpu_torch.graph import config, plan
from sdrreceiver_tpu_torch.io import iqfile
from sdrreceiver_tpu_torch.kernels import (
    dc,
    design,
    fir,
    halfband,
    ingest,
    nco,
    polyphase,
    usbdemod,
)

# six xdist workers share the machine's cores: a few torch threads each
torch.set_num_threads(2)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ------------------------------------------------------------------ design
@pytest.mark.parametrize(
    "build",
    [
        lambda m: m.half_band(11),
        lambda m: m.half_band(15),
        lambda m: m.half_band(21),
        lambda m: m.half_band(23),
        lambda m: m.half_band(51),
        lambda m: m.hilbert(),
        lambda m: m.hilbert(31),
        lambda m: m.low_pass(2.0, 12000.0, 4000.0, 1000.0, m.Window.HAMMING),
        lambda m: m.low_pass(2.0, 48000.0, 10000.0, 2500.0, m.Window.HAMMING),
        lambda m: m.low_pass(1.0, 1536000.0, 100000.0, 20000.0, m.Window.BLACKMAN),
        lambda m: m.window(m.Window.HANN, 33),
        lambda m: m.window(m.Window.BLACKMAN_HARRIS, 64),
    ],
    ids=["hb11", "hb15", "hb21", "hb23", "hb51", "hilbert", "hilbert31",
         "lp12k", "lp48k", "lp_blackman", "hann", "blackman_harris"],
)
def test_design_arrays_bit_equal(build):
    np.testing.assert_array_equal(build(design), build(jdesign))  # exact


def test_design_scalars_and_late_taps_equal():
    assert design.compute_ntaps(48000.0, 2500.0) == jdesign.compute_ntaps(48000.0, 2500.0)
    assert design.HILBERT_DELAY == jdesign.HILBERT_DELAY
    for rate, factor in ((12000, 5), (48000, 5), (48000, 6)):
        np.testing.assert_array_equal(  # exact
            polyphase.late_decim_taps(rate, factor),
            jpolyphase.late_decim_taps(rate, factor),
        )


# ------------------------------------------------------- config and plan
_INIS = [
    test_pallas.TestPallasReceiver.INI,
    test_pallas.TestPallasEdgeGroups.DIRECT_INI,
    test_pallas.TestPallasEdgeGroups.STAGES0_INI,
]


def _plans():
    """(port plan, JAX plan) pairs: the flagship, the late-/5 plan and the
    inis of tests/test_pallas.py."""
    out = [
        (plan.build_plan(flagship.benchmark_config()),
         jplan.build_plan(graft._benchmark_config())),
    ]
    alt = graft._altrate_config()
    out.append((plan.build_plan(config.parse_ini_text(_to_ini(alt))), jplan.build_plan(alt)))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for ini in _INIS:
            out.append((plan.build_plan(config.parse_ini_text(ini)),
                        jplan.build_plan(jconfig.parse_ini_text(ini))))
    return out


def _to_ini(cfg) -> str:
    lines = [
        f"sample_rate={cfg.sample_rate}",
        f"center_frequency={cfg.center_frequency}",
        f"zmq_address={cfg.zmq_address}",
        f"correct_dc_bias={int(cfg.correct_dc_bias)}",
        "[main_vfos]",
        f"size={len(cfg.main_vfos)}",
    ]
    for i, m in enumerate(cfg.main_vfos, 1):
        lines += [f"{i}\\frequency={m.frequency}", f"{i}\\out_rate={m.out_rate}"]
    lines += ["[vfos]", f"size={len(cfg.vfos)}"]
    for i, s in enumerate(cfg.vfos, 1):
        lines += [
            f"{i}\\frequency={s.frequency}", f"{i}\\topic={s.topic}",
            f"{i}\\gain={s.gain}", f"{i}\\data_rate={s.data_rate}",
            f"{i}\\filter_bandwidth={s.filter_bandwidth}",
        ]
    return "\n".join(lines)


def test_flagship_config_equals_graft_entry():
    assert dataclasses.asdict(flagship.benchmark_config()) == dataclasses.asdict(
        graft._benchmark_config()
    )


@pytest.mark.parametrize("ini", range(len(_INIS)))
def test_parse_ini_text_equal(ini):
    assert dataclasses.asdict(config.parse_ini_text(_INIS[ini])) == dataclasses.asdict(
        jconfig.parse_ini_text(_INIS[ini])
    )


def test_build_plan_field_for_field():
    for ours, ref in _plans():
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)  # exact
        assert ours.block_divisor() == ref.block_divisor()
        assert ours.all_topics() == ref.all_topics()
        for g, jg in zip(ours.groups, ref.groups):
            for b, jb in zip(g.buckets, jg.buckets):
                for fn in ("mixer_freqs", "gains", "late_taps", "audio_taps"):
                    a, r = getattr(b, fn)(), getattr(jb, fn)()
                    assert (a is None) == (r is None), fn
                    if a is not None:
                        np.testing.assert_array_equal(a, r)  # exact


# ------------------------------------------------------------------ io
def test_synthesize_and_u8_equal(tmp_path):
    chans = [(1545005000, 700.0, 4.0), (1546005000, 900.0, 3.0)]
    ours = iqfile.synthesize_channels(4096, 1536000, 1545600000, chans, 1.0, 2 - 1j, 3)
    ref = jiqfile.synthesize_channels(4096, 1536000, 1545600000, chans, 1.0, 2 - 1j, 3)
    np.testing.assert_array_equal(ours, ref)  # exact
    jiqfile.write_iq(tmp_path / "x.u8", ref, "u8")
    np.testing.assert_array_equal(iqfile.to_u8(ours), np.fromfile(tmp_path / "x.u8", np.uint8))


# -------------------------------------------------------------- ingest
def test_ingest_exact(rng):
    raw = rng.integers(0, 256, 2048).astype(np.uint8)
    ours = ingest.u8_iq_to_planar(torch.from_numpy(raw))
    ref = jingest.u8_iq_to_planar(jnp.asarray(raw))
    for a, r in zip(ours, ref):
        np.testing.assert_array_equal(_np(a), np.asarray(r))  # exact
    f = rng.standard_normal(2048).astype(np.float32)
    for a, r in zip(ingest.f32_pairs_to_planar(torch.from_numpy(f)),
                    jingest.f32_pairs_to_planar(jnp.asarray(f))):
        np.testing.assert_array_equal(_np(a), np.asarray(r))  # exact


# ------------------------------------------------------------------ dc
def test_dc_block_planar_three_blocks(rng):
    t_len = 256 * 300 + 17  # ragged last row
    mean, jmean = dc.dc_init_planar("cpu"), jdc.dc_init_planar()
    for _ in range(3):
        x = (rng.standard_normal((2, t_len)) * 20 + [[3.0], [-2.0]]).astype(np.float32)
        mean, (yr, yi) = dc.dc_block_planar(mean, (torch.from_numpy(x[0]), torch.from_numpy(x[1])))
        jmean, (jyr, jyi) = jdc.dc_block_planar(jmean, (jnp.asarray(x[0]), jnp.asarray(x[1])))
        np.testing.assert_allclose(_np(yr), np.asarray(jyr), rtol=0, atol=1e-4)
        np.testing.assert_allclose(_np(yi), np.asarray(jyi), rtol=0, atol=1e-4)
        np.testing.assert_allclose(_np(mean), np.asarray(jmean), rtol=1e-5, atol=0)


def test_dc_prefix_tables_equal():
    np.testing.assert_array_equal(dc._prefix_matrix(1e-6, 256), jdc._prefix_matrix(1e-6, 256))
    n = np.arange(0, 2_000_000, 997)
    np.testing.assert_array_equal(  # exact: float64 power, one rounding
        dc._decay(1e-6, torch.from_numpy(n)).numpy(),
        jdc.decay_pow(1e-6, n).astype(np.float32),
    )


# ----------------------------------------------------------------- nco
@pytest.mark.parametrize("fs", [1536000, 384000, 192000, 1920000])
def test_nco_phase_integers_exact(fs):
    freqs = np.array([484000, -496000, 110854, 0, fs - 1, -fs + 3])
    st = nco.nco_init(freqs, fs, "cpu")
    jst = jnco.nco_init(freqs, fs)
    for k in ("phase", "f", "fK"):
        np.testing.assert_array_equal(st[k].numpy(), np.asarray(jst[k]).astype(np.int64))
    for t_len in (1, 255, 49152, 1536000, 2_000_000):
        st["phase"] = nco.advance_per_block(st, fs, t_len)
        jst["phase"] = jnco.advance_per_block(jst, fs, t_len)
        np.testing.assert_array_equal(st["phase"].numpy(), np.asarray(jst["phase"]).astype(np.int64))
        np.testing.assert_array_equal(  # exact
            nco.phase_minus(st, fs, t_len // 3 + 7).numpy(),
            np.asarray(jnco.phase_minus(jst, fs, t_len // 3 + 7)).astype(np.int64),
        )


@pytest.mark.parametrize("shared", [True, False])
def test_mix_block_planar(rng, shared):
    fs, t_len = 384000, 5000
    freqs = np.array([-110854, 95000, 12345])
    shape = (t_len,) if shared else (3, t_len)
    x = rng.uniform(-128, 128, (2,) + shape).astype(np.float32)
    st = nco.nco_init(freqs, fs, "cpu")
    jst = jnco.nco_init(freqs, fs)
    st["phase"] = torch.tensor([5, 383999, 77])
    jst["phase"] = jnp.asarray(np.array([5, 383999, 77], np.uint32))
    for _ in range(2):
        st, (yr, yi) = nco.mix_block_planar(st, (torch.from_numpy(x[0]), torch.from_numpy(x[1])), fs)
        jst, (jyr, jyi) = jnco.mix_block_planar(jst, (jnp.asarray(x[0]), jnp.asarray(x[1])), fs)
        np.testing.assert_array_equal(st["phase"].numpy(), np.asarray(jst["phase"]).astype(np.int64))
        np.testing.assert_allclose(yr.numpy(), np.asarray(jyr), rtol=0, atol=1e-4)
        np.testing.assert_allclose(yi.numpy(), np.asarray(jyi), rtol=0, atol=1e-4)


# ------------------------------------------------------- fir and cascade
@pytest.mark.parametrize("stride", [1, 2, 5])
def test_conv_block_streaming(rng, stride):
    taps = rng.standard_normal((4, 30)).astype(np.float32)
    rt, jrt = fir.prepare_taps(taps, 4), jfir.prepare_taps(taps, 4)
    np.testing.assert_array_equal(rt.numpy(), jrt)
    hist, jhist = torch.zeros(4, 29), jnp.zeros((4, 29), jnp.float32)
    for _ in range(3):
        x = rng.standard_normal((4, 600)).astype(np.float32)
        hist, y = fir.conv_block(hist, torch.from_numpy(x), rt, stride)
        jhist, jy = jfir.conv_block(jhist, jnp.asarray(x), jrt, stride)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=1e-4)
        np.testing.assert_allclose(hist.numpy(), np.asarray(jhist), rtol=0, atol=1e-4)


def test_conv_block_planar_and_delay(rng):
    rt = fir.prepare_taps(design.hilbert(), 3)
    jrt = jfir.prepare_taps(jdesign.hilbert(), 3)
    hist = fir.fir_history_init_planar(3, 125, "cpu")
    jhist = jfir.fir_history_init_planar(3, 125)
    dh, jdh = torch.zeros(3, 62), jnp.zeros((3, 62), jnp.float32)
    for _ in range(2):
        x = rng.standard_normal((2, 3, 500)).astype(np.float32)
        hist, (yr, yi) = fir.conv_block_planar(hist, (torch.from_numpy(x[0]), torch.from_numpy(x[1])), rt, 2)
        jhist, (jyr, jyi) = jfir.conv_block_planar(jhist, (jnp.asarray(x[0]), jnp.asarray(x[1])), jrt, 2)
        np.testing.assert_allclose(yr.numpy(), np.asarray(jyr), rtol=0, atol=1e-4)
        np.testing.assert_allclose(yi.numpy(), np.asarray(jyi), rtol=0, atol=1e-4)
        dh, d = fir.delay_apply(dh, torch.from_numpy(x[0]))
        jdh, jd = jfir.delay_apply(jdh, jnp.asarray(x[0]))
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))  # a delay is exact
        np.testing.assert_array_equal(dh.numpy(), np.asarray(jdh))


def test_conv_runs_without_tf32(rng, monkeypatch):
    """cuDNN would run float32 convolutions in TF32 by default; every FIR
    call must switch that off for the call and restore it after."""
    seen = []
    real = torch.nn.functional.conv1d

    def spy(*args, **kwargs):
        seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
        return real(*args, **kwargs)

    monkeypatch.setattr(torch.nn.functional, "conv1d", spy)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    x = torch.from_numpy(rng.standard_normal((2, 256)).astype(np.float32))
    fir.conv_block(torch.zeros(2, 10), x, fir.prepare_taps(np.ones(11), 2), 2)
    halfband.cascade_apply_planar(halfband.cascade_init_planar(2, 2, "cpu"), (x, x),
                                  fir.prepare_taps(design.half_band(), 2))
    assert seen and all(s == (False, False) for s in seen)
    assert torch.backends.cudnn.allow_tf32 is True


def test_cascade_apply_and_tails(rng):
    c, stages = 3, 4
    rt = fir.prepare_taps(design.half_band(11), c)
    jrt = jfir.prepare_taps(jdesign.half_band(11), c)
    hists = halfband.cascade_init_planar(c, stages, "cpu")
    jhists = jhalfband.cascade_init_planar(c, stages)
    for _ in range(3):
        x = rng.uniform(-128, 128, (2, c, 1024)).astype(np.float32)
        hists, (yr, yi) = halfband.cascade_apply_planar(hists, (torch.from_numpy(x[0]), torch.from_numpy(x[1])), rt)
        jhists, (jyr, jyi) = jhalfband.cascade_apply_planar(jhists, (jnp.asarray(x[0]), jnp.asarray(x[1])), jrt)
        np.testing.assert_allclose(yr.numpy(), np.asarray(jyr), rtol=0, atol=1e-4)
        np.testing.assert_allclose(yi.numpy(), np.asarray(jyi), rtol=0, atol=1e-4)
        for h, jh in zip(hists, jhists):
            np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=0, atol=1e-4)
    tail = rng.uniform(-128, 128, (2, c, 512)).astype(np.float32)
    tails = halfband.cascade_tails_from_tail((torch.from_numpy(tail[0]), torch.from_numpy(tail[1])), rt, stages)
    jtails = jhalfband.cascade_tails_from_tail((jnp.asarray(tail[0]), jnp.asarray(tail[1])), jrt, stages)
    assert len(tails) == len(jtails) == stages
    for h, jh in zip(tails, jtails):
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=0, atol=1e-4)


# ----------------------------------------------------------------- usb
def test_usb_block_planar(rng):
    c = 4
    rt = fir.prepare_taps(design.hilbert(), c)
    jrt = jfir.prepare_taps(jdesign.hilbert(), c)
    st, jst = usbdemod.usb_init(c, "cpu"), jusb.usb_init(c)
    for _ in range(2):
        x = rng.standard_normal((2, c, 700)).astype(np.float32)
        st, a = usbdemod.usb_block_planar(st, (torch.from_numpy(x[0]), torch.from_numpy(x[1])), rt)
        jst, ja = jusb.usb_block_planar(jst, (jnp.asarray(x[0]), jnp.asarray(x[1])), jrt)
        np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=0, atol=1e-4)
        for k in ("delay_hist", "hilb_hist"):
            np.testing.assert_allclose(st[k].numpy(), np.asarray(jst[k]), rtol=0, atol=1e-4)


def test_quantize_i16_bit_exact(rng):
    gains = np.array([0.05, 0.04, 1.0], np.float32)
    scale = (gains * np.float32(32768.0))[:, None]
    ties = np.array([0.5, -0.5, 1.5, -1.5, 2.5, -2.5, 32766.5, -32767.5], np.float32)
    sat = np.array([32767.4, 32767.5, 40000.0, -32768.5, -40000.0, 0.0, -0.0, 1e9], np.float32)
    audio = np.stack([
        np.concatenate([ties, sat]) / scale[i, 0] for i in range(3)
    ]).astype(np.float32)
    audio = np.concatenate([audio, rng.standard_normal((3, 4000)).astype(np.float32) * 2], axis=1)
    ours = usbdemod.quantize_i16(torch.from_numpy(audio), torch.from_numpy(gains))
    ref = jusb.quantize_i16(jnp.asarray(audio), jnp.asarray(gains))
    assert ours.dtype == torch.int16
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))  # bit-exact
    # the scaled tie values round half to even on the gain-1 row
    np.testing.assert_array_equal(
        ours.numpy()[2, :8], [0, 0, 2, -2, 2, -2, 32766, -32768]
    )
