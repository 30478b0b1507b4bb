"""The port's late decimation, overlap-save FFT, IQ compression, spectrum,
scope taps, burst entries, runtime and stream helpers vs the JAX package.

Inputs are made from numpy seeds and go through the JAX function and its
counterpart in ``sdrreceiver_tpu_torch``; each assert states its tolerance.
Runs on the CPU.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdrreceiver_tpu.core import runtime as jruntime
from sdrreceiver_tpu.core import stream as jstream
from sdrreceiver_tpu.graph import build_plan as jbuild_plan
from sdrreceiver_tpu.graph import parse_ini_text as jparse
from sdrreceiver_tpu.graph.compiler import CompiledReceiver as JaxReceiver
from sdrreceiver_tpu.kernels import compress as jcompress
from sdrreceiver_tpu.kernels import fir as jfir
from sdrreceiver_tpu.kernels import ossfft as jossfft
from sdrreceiver_tpu.kernels import polyphase as jpolyphase
from sdrreceiver_tpu.obs import metrics as jmetrics
from sdrreceiver_tpu.obs import spectrum as jspectrum
from sdrreceiver_tpu_torch.core import runtime, stream
from sdrreceiver_tpu_torch.flagship import altrate_config
from sdrreceiver_tpu_torch.graph.compiler import CompiledReceiver
from sdrreceiver_tpu_torch.graph.config import parse_ini_text
from sdrreceiver_tpu_torch.graph.plan import build_plan
from sdrreceiver_tpu_torch.io.iqfile import synthesize_channels, to_u8
from sdrreceiver_tpu_torch.kernels import compress, fir, ossfft, polyphase
from sdrreceiver_tpu_torch.obs import metrics, spectrum
from test_torch_altrate import PLANS
from test_torch_modules import _to_ini

# six xdist workers share the machine's cores: a few torch threads each
torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --------------------------------------------------------- late /5 /6
@pytest.mark.parametrize("rate,factor", [(12000, 5), (48000, 5), (48000, 6)])
def test_late_decim_apply_three_blocks(rng, rate, factor):
    """Planar port vs the JAX complex form over 3 carried blocks: outputs
    and history to atol 1e-4 (inputs ~N(0, 1), 50 or 74 taps)."""
    taps = polyphase.late_decim_taps(rate, factor)
    taps = np.concatenate([[0.0], taps]).astype(np.float32)  # the plan's leading zero
    c = 3
    rt, jrt = fir.prepare_taps(taps, c), jfir.prepare_taps(taps, c)
    hist = fir.fir_history_init_planar(c, len(taps), "cpu")
    jhist = jnp.zeros((c, len(taps) - 1), jnp.complex64)
    for _ in range(3):
        x = rng.standard_normal((2, c, 60 * factor)).astype(np.float32)
        hist, (yr, yi) = polyphase.late_decim_apply(hist, (_t(x[0]), _t(x[1])), rt, factor)
        jhist, jy = jpolyphase.late_decim_apply(jhist, jnp.asarray(x[0] + 1j * x[1]), jrt, factor)
        assert yr.shape == (c, 60)
        np.testing.assert_allclose(yr.numpy(), np.asarray(jy).real, rtol=0, atol=1e-4)
        np.testing.assert_allclose(yi.numpy(), np.asarray(jy).imag, rtol=0, atol=1e-4)
        np.testing.assert_allclose(hist[0].numpy() + 1j * hist[1].numpy(), np.asarray(jhist),
                                   rtol=0, atol=1e-4)


# ------------------------------------------------------- overlap-save
@pytest.mark.parametrize("complex_in", [False, True], ids=["real", "complex"])
@pytest.mark.parametrize("stride", [1, 2])
def test_oss_block_three_blocks(rng, complex_in, stride):
    """vs the JAX oss_block and the port's own direct conv_block, 3 carried
    blocks of ragged lengths (one shorter than a hop, so the last segment
    is padded): atol 1e-4 x input scale (inputs ~N(0, 1))."""
    c, ntaps = 3, 156
    taps = rng.standard_normal((c, ntaps)).astype(np.float32) / 10
    filt, jfilt = ossfft.oss_prepare(taps), jossfft.oss_prepare(taps)
    np.testing.assert_array_equal(filt["Hr"].numpy(), jfilt["Hr"])  # same numpy math
    np.testing.assert_array_equal(filt["H"].numpy(), jfilt["H"])
    assert (filt["ntaps"], filt["nfft"]) == (jfilt["ntaps"], jfilt["nfft"]) == (ntaps, 1024)
    dt = torch.complex64 if complex_in else torch.float32
    hist, dhist = torch.zeros(c, ntaps - 1, dtype=dt), torch.zeros(c, ntaps - 1)
    jhist = jnp.zeros((c, ntaps - 1), jnp.complex64 if complex_in else jnp.float32)
    rt = fir.prepare_taps(taps)
    for t_len in (2000, 64, 1500):
        x = rng.standard_normal((c, t_len)).astype(np.float32)
        if complex_in:
            x = (x + 1j * rng.standard_normal((c, t_len))).astype(np.complex64)
        hist, y = ossfft.oss_block(hist, _t(x), filt, stride)
        jhist, jy = jossfft.oss_block(jhist, jnp.asarray(x), jfilt, stride)
        assert y.dtype == dt and y.shape == (c, t_len // stride)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=1e-4)
        np.testing.assert_array_equal(hist.numpy(), np.asarray(jhist))  # a copy of inputs
        if not complex_in:
            dhist, yd = fir.conv_block(dhist, _t(x), rt, stride)
            np.testing.assert_allclose(y.numpy(), yd.numpy(), rtol=0, atol=1e-4)


@pytest.mark.parametrize("ntaps", [1, 30, 128, 156, 513])
def test_default_nfft_equal(ntaps):
    assert ossfft.default_nfft(ntaps) == jossfft.default_nfft(ntaps)


# ------------------------------------------------------- compression
def _compress_inputs(rng, scale):
    edges = np.array([0.0, -0.0, 1 / 128, -1 / 128, 2 / 128, -2 / 128, 15 / 128, 16 / 128,
                      -16 / 128, -17 / 128, 0.999, -0.999, 1.0, -1.0, 1.5, -1.5, 127 / 128,
                      -128 / 128, 40.0, -40.0], np.float32) * np.float32(scale)
    x = (rng.standard_normal((2, 20000)) * 0.6 * scale).astype(np.float32)
    return np.concatenate([np.stack([edges, edges[::-1]]), x], axis=1)


@pytest.mark.parametrize("scale", [1.0, 3.0, 0.3])
def test_compress_style1_planar_bit_exact(rng, scale):
    x = _compress_inputs(rng, scale)
    ours = compress.compress_style1_planar((_t(x[0]), _t(x[1])), scale)
    ref = jcompress.compress_style1_planar((jnp.asarray(x[0]), jnp.asarray(x[1])), scale)
    assert ours.dtype == torch.uint8
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))  # bit-exact


def test_compress_style1_and_style2_bit_exact(rng):
    x = _compress_inputs(rng, 1.0)
    z = (x[0] + 1j * x[1]).astype(np.complex64)
    np.testing.assert_array_equal(  # bit-exact
        compress.compress_style1(_t(z), 2.0).numpy(), np.asarray(jcompress.compress_style1(jnp.asarray(z), 2.0))
    )
    ours = compress.compress_style2(_t(z.reshape(4, -1)))
    assert ours.dtype == torch.int8 and ours.shape == (4, 2 * z.size // 4)
    np.testing.assert_array_equal(  # bit-exact
        ours.numpy(), np.asarray(jcompress.compress_style2(jnp.asarray(z.reshape(4, -1))))
    )


# --------------------------------------------------------- spectrum
@pytest.mark.parametrize("form", ["planar", "complex", "real", "short"])
def test_power_spectrum_equal(rng, form):
    """The reference's scope frame: atol 1e-3 dB."""
    n = 3000 if form == "short" else 9000
    x = rng.standard_normal((2, n)).astype(np.float32) * 50
    x[0] += 400 * np.cos(2 * np.pi * 0.1 * np.arange(n)).astype(np.float32)
    arg = {"planar": x, "short": x, "complex": (x[0] + 1j * x[1]).astype(np.complex64),
           "real": x[0]}[form]
    ours = spectrum.power_spectrum(_t(arg))
    ref = np.asarray(jspectrum.power_spectrum(arg))
    assert ours.shape == (8192,) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-3)


def test_spectrum_ema_smoothed_equal(rng):
    ema, jema = spectrum.SpectrumEMA(), jspectrum.SpectrumEMA()
    for _ in range(3):
        x = rng.standard_normal((2, 8192)).astype(np.float32) * 30
        ema.update(_t(x))
        jema.update(x)
    np.testing.assert_allclose(ema.smoothed, jema.smoothed, rtol=0, atol=1e-3)  # dB


# --------------------------------------------------------- scope taps
@pytest.mark.parametrize("name", sorted(PLANS))
def test_tap_rates_rates_shapes_equal(name):
    text, block = PLANS[name]
    rx = CompiledReceiver(build_plan(parse_ini_text(text)), block, device="cpu")
    jrx = JaxReceiver(jbuild_plan(jparse(text)), block)
    assert rx.tap_rates() == jrx.tap_rates()
    assert rx.rates() == jrx.rates()
    assert rx.output_shapes() == jrx.output_shapes()


def _renamed(old: str, new: str) -> str:
    return PLANS["iq"][0].replace(f"topic={old}", f"topic={new}")


@pytest.mark.parametrize(
    "text,taps,match",
    [
        (PLANS["iq"][0], ("VFO99",), "unknown taps"),
        (_renamed("VFO02", "VFO01"), (), "duplicate sub-VFO topic"),
        (_renamed("VFO02", "g1"), (), "scope tap name collision"),
        (_renamed("VFO13", "main"), (), "scope tap name collision"),
    ],
    ids=["unknown", "duplicate", "reserved_g", "reserved_main"],
)
def test_tap_errors_as_jax(text, taps, match):
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        plan, jplan = build_plan(parse_ini_text(text)), jbuild_plan(jparse(text))
    with pytest.raises(ValueError, match=match):
        JaxReceiver(jplan, 49152, emit_taps=taps)
    with pytest.raises(ValueError, match=match):
        CompiledReceiver(plan, 49152, emit_taps=taps, device="cpu")


# ---------------------------------------------------- burst entries
@pytest.fixture(scope="module")
def alt_rx():
    text = _to_ini(altrate_config())
    return CompiledReceiver(build_plan(parse_ini_text(text)), 15360, emit_taps=("g1", "AL001"),
                            device="cpu")


def _alt_blocks(rx, k):
    plan = rx.plan
    subs = [s for g in plan.groups for b in g.buckets for s in b.subs]
    iq = synthesize_channels(k * rx.block, plan.fs, plan.center_frequency,
                             [(s.frequency, 700 + 37 * i, 1.0) for i, s in enumerate(subs)],
                             noise=0.5, dc_offset=1 - 2j, seed=5)
    return to_u8(iq).reshape(k, -1)


@pytest.mark.parametrize("entry", ["u8", "f32", "iq"])
def test_step_many_equals_single_steps(alt_rx, entry):
    rx, k = alt_rx, 3
    raw = _alt_blocks(rx, k)
    if entry == "u8":
        blocks = _t(raw)
    else:
        f = _t(raw.astype(np.float32) - 127.0)
        blocks = f if entry == "f32" else torch.complex(f[:, 0::2], f[:, 1::2])
    single = getattr(rx, f"step_{entry}")
    s, outs = rx.init_state(), []
    for i in range(k):
        s, o = single(s, blocks[i])
        outs.append(o)
    ms, many = getattr(rx, f"step_many_{entry}")(rx.init_state(), blocks)
    for i, o in enumerate(rx.unstack_outputs(many, k)):
        assert set(o) == set(outs[i])
        for key in o:
            assert torch.equal(o[key], outs[i][key]), (i, key)
    for (k1, a), (k2, b) in zip(rx.export_state(s).items(), rx.export_state(ms).items()):
        assert k1 == k2 and np.array_equal(a, b), k1


# ------------------------------------------------------------ runtime
def _by_hand(rx, raw, keep=lambda k: True):
    s, frames = rx.init_state(), []
    for blk in raw:
        s, o = rx.step_u8(s, _t(blk))
        frames.append(rx.split_audio({k: v.numpy() for k, v in o.items() if keep(k)}))
    return s, frames


@pytest.mark.parametrize("burst", [1, 2, 4])
def test_run_pipeline_equals_hand_steps(alt_rx, burst):
    """burst 2 over 5 blocks runs two bursts and a single-step tail."""
    rx = alt_rx
    raw = _alt_blocks(rx, 5)
    s_ref, ref = _by_hand(rx, raw)
    got = []
    m, s = runtime.run_pipeline(rx, iter(raw), lambda o: got.append(o) or 2,
                                return_state=True, burst=burst)
    assert m.blocks == 5 and m.samples_in == 5 * rx.block and m.messages_sent == 10
    assert len(got) == 5
    for a, b in zip(got, ref):
        assert set(a) == set(b)
        for k in b:
            assert isinstance(a[k], np.ndarray) and np.array_equal(a[k], b[k]), k
    for (k1, a), (k2, b) in zip(rx.export_state(s).items(), rx.export_state(s_ref).items()):
        assert k1 == k2 and np.array_equal(a, b), k1


def test_run_pipeline_fetch_filter_and_max_blocks(alt_rx):
    rx = alt_rx
    raw = _alt_blocks(rx, 4)
    keep = lambda k: not k.startswith("tap/")  # noqa: E731
    _, ref = _by_hand(rx, raw[:3], keep)
    got = []
    m = runtime.run_pipeline(rx, iter(raw), lambda o: got.append(o) or 0, max_blocks=3,
                             fetch_filter=keep, raw_u8=True)
    assert m.blocks == 3 and len(got) == 3
    for a, b in zip(got, ref):
        assert set(a) == set(b) and not any(k.startswith("tap/") for k in a)
        assert all(np.array_equal(a[k], b[k]) for k in b)
    with pytest.raises(ValueError, match="burst"):
        runtime.run_pipeline(rx, iter(raw), burst=2, realtime_fs=1)


def test_pipeline_metrics_summary_keys_equal():
    ours, ref = metrics.PipelineMetrics(), jmetrics.PipelineMetrics()
    for m in (ours, ref):
        m.start()
        for i in range(4):
            m.record_block(1000, 0.001 * (i + 1), 2, pacing_slack=0.01 - 0.005 * i)
        m.finish()
    a, b = ours.summary(), ref.summary()
    # the port names the host's time per block for what it is, and adds
    # the count of units published before the next block was pulled
    assert a.pop("published_early") == 0
    assert [{"host_ms_per_block": "block_latency_ms"}.get(k, k) for k in a] == list(b)
    assert a["host_ms_per_block"] == b["block_latency_ms"]
    assert a["pacing_slack_ms"] == b["pacing_slack_ms"]
    # the JAX package's parameters, in its order, then the port's readiness hook
    sig = inspect.signature
    ours_params = list(sig(runtime.run_pipeline).parameters)
    assert ours_params == list(sig(jruntime.run_pipeline).parameters) + ["source_ready"]


# ------------------------------------------------------------- stream
def test_run_chunked_and_concat_equal_whole(rng):
    c, ntaps = 2, 31
    taps = rng.standard_normal((c, ntaps)).astype(np.float32)
    rt = fir.prepare_taps(taps)
    x = _t(rng.standard_normal((c, 1200)).astype(np.float32))
    h0 = stream.fir_history_init(c, ntaps, torch.float32)
    assert h0.shape == (c, ntaps - 1) and h0.dtype == torch.float32
    assert tuple(jstream.fir_history_init(None, ntaps).shape) == tuple(
        stream.fir_history_init(None, ntaps).shape)
    h_whole, y_whole = fir.conv_block(h0, x, rt)
    h_ch, ys = stream.run_chunked(lambda h, b: fir.conv_block(h, b, rt), h0, x, 300)
    assert len(ys) == 4
    np.testing.assert_allclose(stream.concat_outputs(ys).numpy(), y_whole.numpy(),
                               rtol=0, atol=1e-5)
    assert stream.tree_allclose({"h": h_ch, "y": ys}, {"h": h_whole, "y": list(torch.split(y_whole, 300, -1))})
    with pytest.raises(ValueError, match="divisible"):
        stream.run_chunked(lambda h, b: (h, b), h0, x, 7)


def test_tree_allclose_as_jax():
    a = {"x": torch.ones(3), "y": [torch.zeros(2), torch.full((1,), 2.0)]}
    b = {"x": torch.ones(3) + 1e-7, "y": [torch.zeros(2), torch.full((1,), 2.0)]}
    ja = {"x": np.ones(3), "y": [np.zeros(2), np.full(1, 2.0)]}
    assert stream.tree_allclose(a, b) and jstream.tree_allclose(ja, ja)
    assert not stream.tree_allclose(a, {"x": torch.ones(3), "y": [torch.zeros(2)]})
    assert not stream.tree_allclose(a, dict(b, x=torch.zeros(3)))
    assert stream.concat_outputs([{"a": (torch.ones(1, 2),)}, {"a": (torch.zeros(1, 3),)}])["a"][0].shape == (1, 5)

