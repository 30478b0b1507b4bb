"""The port's receivers beyond the flagship vs the JAX receiver, end to end.

Four plans, each over 3 consecutive u8 blocks through the port (CPU: every
kernel wrapper takes its plain version) and through the JAX receiver with
Pallas in interpret mode and without:

  alt  the 1.92 Msps alt-rate plan (``flagship.altrate_config``): merged
       front C=2 d=[3,3], bucket g0/b0 C=3 d=2 /5-late, g1/b0 d=0 /5-late
  192  ``tests/test_altrate_e2e.py``'s INI_192 (one group, /5-late buckets)
  288  its INI_288: a mix-only group and a pure /6 chain, no DC correction
  iq   ``tests/test_receiver_e2e.py``'s SMALL_INI (group 1 forwards IQ on
       IQFWD) with VFO13 given a 3 kHz filter (156 taps: overlap-save),
       scope taps main, g0 and VFO01

Bars: int16 audio as ``test_torch_receiver._assert_audio_close`` (<= 1 LSB,
flip rate < 1e-3 pooled); IQ bytes differ in under 1e-3 of samples and by
at most one step of either nibble (floats an ulp apart can cross a multiple
of 1/128); taps to atol 1e-4 x the tap's peak; state leaves as in the
flagship test.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
import test_altrate_e2e
import test_receiver_e2e
from sdrreceiver_tpu.graph import build_plan as jbuild_plan
from sdrreceiver_tpu.graph import parse_ini_text as jparse
from sdrreceiver_tpu.graph.compiler import CompiledReceiver as JaxReceiver
from sdrreceiver_tpu_torch.flagship import altrate_config
from sdrreceiver_tpu_torch.graph.compiler import CompiledReceiver
from sdrreceiver_tpu_torch.graph.config import parse_ini_text
from sdrreceiver_tpu_torch.graph.plan import build_plan
from sdrreceiver_tpu_torch.io.iqfile import synthesize_channels, to_u8
from test_torch_modules import _to_ini
from test_torch_receiver import _assert_audio_close

# six xdist workers share the machine's cores: a few torch threads each
torch.set_num_threads(2)

N_BLOCKS = 3
IQ_INI = test_receiver_e2e.SMALL_INI.replace(
    "3\\topic=VFO13", "3\\filter_bandwidth=3000\n3\\topic=VFO13"
)
IQ_TAPS = ("main", "g0", "VFO01")

#: name -> (ini text, block)
PLANS = {
    "alt": (_to_ini(altrate_config()), 153600),
    "192": (test_altrate_e2e.INI_192, 153600),
    "288": (test_altrate_e2e.INI_288, 57600),
    "iq": (IQ_INI, 49152),
}


def _signal(plan, block: int, amp: float) -> np.ndarray:
    """[N_BLOCKS, 2*block] u8: a USB tone in every sub-VFO, noise, a DC
    offset (seeded)."""
    subs = [s for g in plan.groups for b in g.buckets for s in b.subs]
    iq = synthesize_channels(
        N_BLOCKS * block, plan.fs, plan.center_frequency,
        [(s.frequency, 700 + 37 * i, amp) for i, s in enumerate(subs)],
        noise=amp / 2, dc_offset=2 - 1j, seed=0,
    )
    return to_u8(iq).reshape(N_BLOCKS, 2 * block)


def _run_jax(rx, raw, state=None, first=0):
    s = rx.init_state() if state is None else state
    outs, states = [], []
    for i in range(first, N_BLOCKS):
        s, o = rx.step_u8(s, jnp.asarray(raw[i]))
        outs.append(rx.split_audio({k: np.asarray(v) for k, v in o.items()}))
        states.append(rx.export_state(s))
    return outs, states


def _run_port(rx, raw, state=None, first=0):
    s = rx.init_state() if state is None else state
    outs, states = [], []
    for i in range(first, N_BLOCKS):
        s, o = rx.step_u8(s, torch.from_numpy(raw[i]))
        outs.append(rx.split_audio({k: v.numpy() for k, v in o.items()}))
        states.append(rx.export_state(s))
    return outs, states


@pytest.fixture(scope="module")
def runs():
    """name -> the plan's runs, computed on first use."""
    cache = {}

    def get(name):
        if name not in cache:
            text, block = PLANS[name]
            taps = IQ_TAPS if name == "iq" else ()
            plan, jplan = build_plan(parse_ini_text(text)), jbuild_plan(jparse(text))
            # the iq plan's audio is quieter: its short outputs (384 samples
            # per block) leave little room under the pooled flip-rate bar
            raw = _signal(plan, block, 0.5 if name == "iq" else 1.0)
            rx = CompiledReceiver(plan, block, emit_taps=taps, device="cpu")
            jrx = JaxReceiver(jplan, block, emit_taps=taps)
            jpal = JaxReceiver(jplan, block, emit_taps=taps, use_pallas=True, pallas_interpret=True)
            cache[name] = {
                "plan": plan, "raw": raw, "rx": rx, "jrx": jrx, "jpal": jpal,
                "port": _run_port(rx, raw), "jnp": _run_jax(jrx, raw),
                "pallas": _run_jax(jpal, raw),
            }
        return cache[name]

    return get


def _audio(outs):
    return [{k: v for k, v in o.items() if k.startswith("audio/")} for o in outs]


@pytest.mark.parametrize("ref", ["pallas", "jnp"])
@pytest.mark.parametrize("name", sorted(PLANS))
def test_three_blocks_audio_match_jax(runs, name, ref):
    r = runs(name)
    assert set(r["port"][0][0]) == set(r[ref][0][0])
    _assert_audio_close(_audio(r["port"][0]), _audio(r[ref][0]))


@pytest.mark.parametrize("name", sorted(PLANS))
def test_state_matches_jax_each_block(runs, name):
    """Every leaf after each block, `late` included: same keys, shapes and
    dtypes as the JAX export; NCO integers exact, floats to atol 1e-3."""
    r = runs(name)
    for ours, ref in zip(r["port"][1], r["jnp"][1]):
        assert set(ours) == set(ref)
        for k, v in ref.items():
            assert ours[k].shape == v.shape and ours[k].dtype == v.dtype, k
            if v.dtype == np.uint32:
                np.testing.assert_array_equal(ours[k], v, err_msg=k)
            else:
                np.testing.assert_allclose(ours[k], v, rtol=0, atol=1e-3, err_msg=k)
    if name != "iq":
        assert any(k.endswith("/late") for k in ref)


def test_late_and_audio_state_layouts(runs):
    alt, iq = runs("alt"), runs("iq")
    named = alt["port"][1][0]
    assert named["g0/b0/late"].shape == (3, 49) and named["g0/b0/late"].dtype == np.complex64
    assert named["g1/b0/late"].shape == (3, 49)
    assert alt["rx"].xtail_len() == alt["jrx"].xtail_len() == 2304
    assert set(iq["rx"]._oss) == {"g1/b0"}
    assert iq["port"][1][0]["g1/b0/audio"].shape == (1, 155)  # the direct FIR's layout


@pytest.mark.parametrize("name", sorted(PLANS))
def test_checkpoint_from_jax_resumes_in_port(runs, name):
    """JAX runs blocks 1-2 and exports; the port imports and runs block 3."""
    r = runs(name)
    outs, _ = _run_port(r["rx"], r["raw"], r["rx"].import_state(r["jnp"][1][1]), first=2)
    _assert_audio_close(_audio(outs), _audio(r["jnp"][0][2:]))


@pytest.mark.parametrize("name", sorted(PLANS))
def test_checkpoint_from_port_resumes_in_jax(runs, name):
    """The port runs blocks 1-2 and exports; JAX imports and runs block 3."""
    r = runs(name)
    outs, _ = _run_jax(r["jrx"], r["raw"], r["jrx"].import_state(r["port"][1][1]), first=2)
    _assert_audio_close(_audio(outs), _audio(r["port"][0][2:]))


def _nibbles(b: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Signed high (re) and low (im) nibbles of packed style-1 bytes."""
    hi, lo = (b.astype(np.int32) >> 4) & 0xF, b.astype(np.int32) & 0xF
    return np.where(hi >= 8, hi - 16, hi), np.where(lo >= 8, lo - 16, lo)


@pytest.mark.parametrize("ref", ["pallas", "jnp"])
def test_iq_topic_bytes_match_jax(runs, ref):
    r = runs("iq")
    for ours, theirs in zip(r["port"][0], r[ref][0]):
        a, b = ours["iq/IQFWD"], theirs["iq/IQFWD"]
        assert a.dtype == np.uint8 and a.shape == b.shape == (49152 >> 3,)
        assert (a != b).mean() < 1e-3
        for x, y in zip(_nibbles(a), _nibbles(b)):
            assert np.abs(x - y).max() <= 1


@pytest.mark.parametrize("ref", ["pallas", "jnp"])
def test_taps_match_jax(runs, ref):
    r = runs("iq")
    for ours, theirs in zip(r["port"][0], r[ref][0]):
        for tap in IQ_TAPS:
            a, b = ours[f"tap/{tap}"], theirs[f"tap/{tap}"]
            assert a.dtype == np.float32 and a.shape == b.shape
            assert a.shape == (2, 8192 if tap == "main" else min(8192, b.shape[1]))
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * np.abs(b).max())


def test_overlap_save_audio_matches_direct(runs):
    """The 156-tap bank through overlap-save vs the direct FIR on the same
    blocks: within 1 LSB."""
    r = runs("iq")
    direct = CompiledReceiver(r["plan"], PLANS["iq"][1], emit_taps=IQ_TAPS, ossfft_min_taps=None,
                              device="cpu")
    assert not direct._oss
    _assert_audio_close(_audio(_run_port(direct, r["raw"])[0]), _audio(r["port"][0]))


def test_altrate_config_equals_graft_entry():
    assert dataclasses.asdict(altrate_config()) == dataclasses.asdict(graft._altrate_config())
