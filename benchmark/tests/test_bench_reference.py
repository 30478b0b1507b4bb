"""The plain reference: its stages against cases worked out by hand or by a
per-sample loop, the control's precision, and the whole receiver against
the program on the CPU at a small block."""

import json
import math

import numpy as np
import pytest
import torch

from benchpaths import HERE
from harness import check, gen, program
from reference import design
from reference.receiver import DC_ALPHA, Reference, _tf32, plan

CFGS = {n: json.loads((HERE / "configs" / f"{n}.json").read_text())
        for n in ("flagship_25e", "altrate_54w")}


def _ref(block=3840, n_pool=3, precision="float64", seed=1):
    cfg = CFGS["flagship_25e"]
    return Reference(cfg, gen.recording(cfg, block, n_pool, seed, "cpu"), "cpu", precision)


def test_fir_by_hand():
    r = _ref()
    x = torch.tensor([[1.0, 2.0, 3.0, 4.0, 5.0, 6.0]], dtype=torch.float64)
    taps = np.array([1.0, 10.0, 100.0], np.float32)  # y[n] = x[n] + 10 x[n-1] + 100 x[n-2]
    y = r._fir(x, taps)
    assert y.tolist() == [[1.0, 12.0, 123.0, 234.0, 345.0, 456.0]]
    assert r._fir(x, taps, 2).tolist() == [[1.0, 123.0, 345.0]]  # outputs 0, 2, 4


def test_mix_by_hand():
    """A quarter of the rate turns by 90 degrees a sample, counted from the
    stream's start."""
    r = _ref()
    x = torch.tensor([[1.0] * 4, [0.0] * 4], dtype=torch.float64)
    y = r._mix(x, 1000, 4000, start=5)  # phase of sample 5 = 5/4 turn = 90 degrees
    want = [[0.0, -1.0, 0.0, 1.0], [1.0, 0.0, -1.0, 0.0]]
    assert np.allclose(y.numpy(), want, atol=1e-12)


def test_dc_against_a_loop():
    """The chunked DC mean and its closed form over a cycled recording equal
    the per-sample recursion run from the stream's start."""
    r = _ref(block=1280, n_pool=3)
    n_block = 7  # the stream wraps the 3-block recording twice
    raw = np.concatenate([r.pool[b % 3] for b in range(n_block + 1)]).astype(np.float64) - 127
    x = raw[0::2] + 1j * raw[1::2]
    m, ms = 0j, np.empty(len(x), complex)
    for i, v in enumerate(x):
        m = (1 - DC_ALPHA) * m + DC_ALPHA * v
        ms[i] = m
    before = r.dc_before(n_block).numpy()
    assert abs(complex(*before) - ms[n_block * 1280 - 1]) < 1e-12
    xb = r._x([n_block])
    got = r._ema(xb, torch.tensor(before))
    want = ms[n_block * 1280:]
    assert np.abs(got[0].numpy() - want.real).max() < 1e-12
    assert np.abs(got[1].numpy() - want.imag).max() < 1e-12


def test_quantize_rounds_half_to_even_and_saturates():
    r = _ref()
    c = plan(CFGS["flagship_25e"])[2][0]  # gain 0.05: 1 LSB = 1 / (0.05 * 32768)
    lsb = 1.0 / (c.gain * 32768.0)
    vals = torch.tensor([0.5, 1.5, 2.5, -0.5, 1e6, -1e6], dtype=torch.float64) * lsb
    gain = torch.tensor(c.gain * 32768.0, dtype=torch.float64)
    got = torch.clamp(torch.round(vals * gain), -32768, 32767).to(torch.int16).tolist()
    assert got == [0, 2, 2, 0, 32767, -32768]
    assert r.dtype == torch.float64


def test_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -(1.0 + 2**-12)])
    assert _tf32(x).tolist() == [1.0 + 2**-10, 1.0, 1.0 + 2**-9, -1.0]


def test_taps_by_formula():
    """The designers' lengths and gains as the formulas give them."""
    lp = design.low_pass(2.0, 12000.0, 4000.0, 1000.0)
    assert len(lp) == int(53 * 12000 / 22 / 1000) | 1
    assert abs(float(np.sum(lp.astype(np.float64))) - 2.0) < 1e-6
    h = design.hilbert()
    assert len(h) == 125 and abs(np.sum(h.astype(np.float64) ** 2) - 1) < 1e-6
    assert np.all(h[::2] == 0)  # odd lags only
    assert design.HALF_BAND[5] == 0.5 and np.all(design.HALF_BAND[1::2][[0, 1, 3, 4]] == 0)


@pytest.mark.parametrize("name,block", [("flagship_25e", 38400), ("altrate_54w", 48000)])
def test_reference_matches_the_program_on_the_cpu(name, block):
    """Three blocks of a cycled two-block recording through the program's
    receiver on the CPU: within the benchmark's limits of the reference,
    and the TF32 control is not."""
    cfg = CFGS[name]
    pool = gen.recording(cfg, block, 2, 2**31 + 5, "cpu")
    rx = program.receiver(cfg, block, "cpu")
    state = rx.init_state()
    got = []
    for b in range(3):
        state, outs = rx.step_u8(state, torch.as_tensor(pool[b % 2]))
        got.append({k[6:]: v.numpy() for k, v in rx.split_audio(outs).items()})
    for precision, ok in (("float64", True), ("tf32", False)):
        ref = Reference(cfg, pool, "cpu", precision)
        tally = check.Tally()
        for b in range(3):
            tally.compare(got[b], ref.audio(b))
        assert check.verdict(tally.numbers())[0] is ok, (precision, tally.numbers())
        if ok:
            assert tally.max_lsb <= 1


def test_memory_is_within_one_block():
    for name, block in (("flagship_25e", 384000), ("altrate_54w", 480000)):
        _, _, chains = plan(CFGS[name])
        assert max(c.memory() for c in chains) < block
        assert math.ceil(max(c.memory() for c in chains) / block) == 1
