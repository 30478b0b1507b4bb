"""The PyTorch port's flagship receiver vs the JAX receiver, end to end.

The flagship plan at block 49152, where the JAX receiver engages the merged
front, all three bucket kernels and the u8 DC kernel.  Three consecutive
u8 blocks run through the port (CPU: every kernel wrapper takes its plain
version) and through the JAX receiver, with Pallas in interpret mode and
without Pallas.  Bar: every topic within 1 int16 LSB; flip rate (share of
samples that differ) below 1e-3 pooled over all topics and blocks, and per
topic below max(1e-3, 8 / n), the JAX package's own floor for short
outputs (__graft_entry__.dryrun_multichip).

Why this signal level: two float32 pipelines that round in different
places differ by ~1e-7 relative, so the share of int16 samples that land
on the other side of a rounding boundary grows with the audio level.  The
tones here (amplitude 1, noise 0.5) give audio rms up to ~4700 LSB, where
the JAX package's own two paths differ in ~0.05% of samples; at amplitude
4 (rms ~19000) they differ in ~0.2%.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from sdrreceiver_tpu.graph import build_plan as jbuild_plan
from sdrreceiver_tpu.graph.compiler import CompiledReceiver as JaxReceiver
from sdrreceiver_tpu_torch.flagship import altrate_config, benchmark_config
from sdrreceiver_tpu_torch.graph import compiler as port_compiler
from sdrreceiver_tpu_torch.graph.compiler import CompiledReceiver
from sdrreceiver_tpu_torch.graph.config import parse_ini_text
from sdrreceiver_tpu_torch.graph.plan import build_plan
from sdrreceiver_tpu_torch.io.iqfile import synthesize_channels, to_u8

# six xdist workers share the machine's cores: a few torch threads each
torch.set_num_threads(2)

BLOCK = 49152
N_BLOCKS = 3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _signal(plan) -> np.ndarray:
    """[N_BLOCKS, 2*BLOCK] u8: a USB tone in every third sub-VFO, noise and
    a DC offset (seeded)."""
    subs = sorted(
        (s for g in plan.groups for b in g.buckets for s in b.subs),
        key=lambda s: s.config_index,
    )
    chans = [(s.frequency, 500 + 37 * i, 1.0) for i, s in enumerate(subs) if i % 3 == 0]
    iq = synthesize_channels(
        N_BLOCKS * BLOCK, plan.fs, plan.center_frequency, chans,
        noise=0.5, dc_offset=2 - 1j, seed=0,
    )
    return to_u8(iq).reshape(N_BLOCKS, 2 * BLOCK)


def _run_jax(rx, raw, state=None, first=0):
    """(outputs per block, exported state after each block)."""
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
    plan = build_plan(benchmark_config())
    jplan = jbuild_plan(graft._benchmark_config())
    raw = _signal(plan)
    rx = CompiledReceiver(plan, BLOCK, device="cpu")
    jrx = JaxReceiver(jplan, BLOCK)
    jpal = JaxReceiver(jplan, BLOCK, use_pallas=True, pallas_interpret=True)
    # the JAX receiver's kernels are all engaged at this block
    assert jpal._front_merged is not None and len(jpal._kernels) == 3
    assert jpal._dc_kernel_u8 is not None
    return {
        "plan": plan, "raw": raw, "rx": rx, "jrx": jrx,
        "port": _run_port(rx, raw),
        "jnp": _run_jax(jrx, raw),
        "pallas": _run_jax(jpal, raw),
    }


def _assert_audio_close(ours: list[dict], ref: list[dict]):
    assert len(ours) == len(ref)
    flips = total = 0
    for i, (a, b) in enumerate(zip(ours, ref)):
        assert set(a) == set(b)
        for k in b:
            assert a[k].dtype == np.int16 and a[k].shape == b[k].shape, k
            d = np.abs(a[k].astype(np.int32) - b[k].astype(np.int32))
            assert d.max() <= 1, (i, k, int(d.max()))
            assert (d > 0).mean() < max(1e-3, 8.0 / d.size), (i, k, (d > 0).mean())
            flips += int((d > 0).sum())
            total += d.size
    assert flips / total < 1e-3, flips / total


@pytest.mark.parametrize("ref", ["pallas", "jnp"])
def test_flagship_three_blocks_match_jax(runs, ref):
    _assert_audio_close(runs["port"][0], runs[ref][0])


def test_flagship_state_matches_jax(runs):
    """The carried state after each block: same keys, shapes and dtypes as
    the JAX export; NCO integers exact, float leaves to atol 1e-3 (the DC
    mean and tails carry u8-scale values)."""
    for ours, ref in zip(runs["port"][1], runs["jnp"][1]):
        assert set(ours) == set(ref)
        for k, r in ref.items():
            a = ours[k]
            assert a.shape == r.shape and a.dtype == r.dtype, k
            if r.dtype == np.uint32:
                np.testing.assert_array_equal(a, r, err_msg=k)
            else:
                np.testing.assert_allclose(a, r, rtol=0, atol=1e-3, err_msg=k)


def test_checkpoint_from_jax_resumes_in_port(runs):
    """JAX runs blocks 1-2 and exports; the port imports and runs block 3."""
    rx, named = runs["rx"], runs["jnp"][1][1]
    outs, _ = _run_port(rx, runs["raw"], rx.import_state(named), first=2)
    _assert_audio_close(outs, runs["jnp"][0][2:])


def test_checkpoint_from_port_resumes_in_jax(runs):
    """The port runs blocks 1-2 and exports; JAX imports and runs block 3."""
    jrx, named = runs["jrx"], runs["port"][1][1]
    outs, _ = _run_jax(jrx, runs["raw"], jrx.import_state(named), first=2)
    _assert_audio_close(outs, runs["port"][0][2:])


def test_import_state_round_trip_and_errors(runs):
    rx = runs["rx"]
    named = runs["port"][1][0]
    back = rx.export_state(rx.import_state(named))
    assert set(back) == set(named)
    for k in named:
        np.testing.assert_array_equal(back[k], named[k])  # exact round trip
    short = dict(named, xtail=named["xtail"][-100:])
    assert rx.export_state(rx.import_state(short))["xtail"].shape == named["xtail"].shape
    with pytest.raises(KeyError, match="g0/nco/phase"):
        rx.import_state({k: v for k, v in named.items() if k != "g0/nco/phase"})
    with pytest.raises(ValueError, match="g1/b0/usb/hilb_hist"):
        rx.import_state(dict(named, **{"g1/b0/usb/hilb_hist": np.zeros((15, 3), np.float32)}))


def test_entries_agree(runs):
    """step_f32 and step_iq on the u8 block's values give step_u8's audio
    bit for bit (one plain path, three ingest forms)."""
    rx, raw = runs["rx"], runs["raw"][0]
    _, o_u8 = rx.step_u8(rx.init_state(), torch.from_numpy(raw))
    f = torch.from_numpy(raw.astype(np.float32) - 127.0)
    _, o_f32 = rx.step_f32(rx.init_state(), f)
    _, o_iq = rx.step_iq(rx.init_state(), torch.complex(f[0::2], f[1::2]))
    for k in o_u8:
        assert torch.equal(o_u8[k], o_f32[k]) and torch.equal(o_u8[k], o_iq[k]), k
    assert rx.rates() == runs["jrx"].rates()
    assert rx.output_shapes() == runs["jrx"].output_shapes()


@pytest.mark.parametrize("ini", ["INI", "DIRECT_INI", "STAGES0_INI"])
def test_other_plans_match_jax(ini):
    """The plans of tests/test_pallas.py: one merged two-group front with
    three buckets; a single cascaded group (per-group front) beside a
    direct group; a mix-only group.  The last two carry depth-7 buckets."""
    import warnings

    import test_pallas
    from sdrreceiver_tpu.graph import parse_ini_text as jparse

    text = getattr(
        test_pallas.TestPallasReceiver if ini == "INI" else test_pallas.TestPallasEdgeGroups,
        ini,
    )
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        plan, jplan = build_plan(parse_ini_text(text)), jbuild_plan(jparse(text))
    raw = _signal(plan)
    rx = CompiledReceiver(plan, BLOCK, device="cpu")
    _assert_audio_close(_run_port(rx, raw)[0], _run_jax(JaxReceiver(jplan, BLOCK), raw)[0])


@pytest.mark.parametrize(
    "block", [49152, 98304, 196608, 384000, 1536000], ids=lambda b: f"block{b}"
)
def test_xtail_len_equals_jax(block):
    plan = build_plan(benchmark_config())
    jplan = jbuild_plan(graft._benchmark_config())
    assert CompiledReceiver(plan, block, device="cpu").xtail_len() == JaxReceiver(jplan, block).xtail_len()


@pytest.mark.parametrize("block,want", [(153600, 2304), (480000, 3328)], ids=lambda b: f"{b}")
def test_xtail_len_equals_jax_altrate(block, want):
    plan = build_plan(altrate_config())
    jplan = jbuild_plan(graft._altrate_config())
    rx = CompiledReceiver(plan, block, device="cpu")
    assert rx.xtail_len() == JaxReceiver(jplan, block).xtail_len() == want


@pytest.mark.parametrize(
    "fs,stages,data_len,base",
    [(1536000, 3, 1536000, None), (1536000, 3, 1536000, 256), (384000, 5, 384000, None),
     (192000, 2, 192000, None), (1536000, 2, 49152, None), (1920000, 3, 1920000, None),
     (288000, 1, 288000, None), (384000, 4, 12288, None)],
)
def test_layout_warmup_equals_pick_warmup(fs, stages, data_len, base):
    from sdrreceiver_tpu.pallas.frontend import pick_warmup

    assert port_compiler._layout_warmup(stages, data_len, fs, base) == pick_warmup(
        stages, data_len, fs, base
    )


# ------------------------------------------------------ short blocks
# A block shorter than the stateless kernels' warm-up carries no xtail, in
# both packages: every group and bucket runs the stateful mix + cascade.
SHORT = {
    "flagship_1024": (benchmark_config, graft._benchmark_config, 1024),
    "flagship_2048": (benchmark_config, graft._benchmark_config, 2048),
    "altrate_1280": (altrate_config, graft._altrate_config, 1280),
}
N_SHORT = 6


def _short_raw(plan, block: int, n: int, seed: int = 0) -> np.ndarray:
    """``[n, 2*block]`` u8: a tone in every sub-VFO, noise, a DC offset."""
    subs = sorted((s for g in plan.groups for b in g.buckets for s in b.subs),
                  key=lambda s: s.config_index)
    iq = synthesize_channels(
        n * block, plan.fs, plan.center_frequency,
        [(s.frequency, 500 + 37 * i, 1.0) for i, s in enumerate(subs)],
        noise=0.5, dc_offset=2 - 1j, seed=seed,
    )
    return to_u8(iq).reshape(n, 2 * block)


def _steps(rx, raw, state=None, jax_rx=False):
    """(per-block split outputs as numpy, exported state after each)."""
    s = rx.init_state() if state is None else state
    outs, states = [], []
    for blk in raw:
        s, o = rx.step_u8(s, jnp.asarray(blk) if jax_rx else torch.from_numpy(blk))
        outs.append(rx.split_audio({k: np.asarray(v) for k, v in o.items()}))
        states.append(rx.export_state(s))
    return outs, states


@pytest.fixture(scope="module")
def short_runs():
    runs = {}
    for name, (cfg, jcfg, block) in SHORT.items():
        plan, jplan = build_plan(cfg()), jbuild_plan(jcfg())
        raw = _short_raw(plan, block, N_SHORT)
        rx = CompiledReceiver(plan, block, device="cpu")
        jrx = JaxReceiver(jplan, block)
        jpal = JaxReceiver(jplan, block, use_pallas=True, pallas_interpret=True)
        runs[name] = {"plan": plan, "raw": raw, "rx": rx, "jrx": jrx,
                      "port": _steps(rx, raw), "jnp": _steps(jrx, raw, jax_rx=True),
                      "pallas": _steps(jpal, raw, jax_rx=True)}
    return runs


@pytest.mark.parametrize("ref", ["pallas", "jnp"])
@pytest.mark.parametrize("name", sorted(SHORT))
def test_short_block_matches_jax(short_runs, name, ref):
    """The port builds and runs at these blocks (no xtail, no mix-cascade
    site, the DC kernel still on the path) within 1 LSB of the JAX receiver
    in both its configurations, over several blocks."""
    r = short_runs[name]
    assert r["rx"].xtail_len() == r["jrx"].xtail_len() == 0
    assert r["rx"].mix_cascades() == {}
    assert "xtail" not in r["port"][1][0]
    _assert_audio_close(r["port"][0], r[ref][0])


@pytest.mark.parametrize("first", ["jax", "port"])
@pytest.mark.parametrize("name", ["flagship_2048", "altrate_1280"])
def test_short_block_checkpoint_crosses(short_runs, name, first):
    """Blocks 1-3 in one package, exported; blocks 4-6 in the other from
    that state: the first package's straight run, within 1 LSB."""
    r = short_runs[name]
    a, b = ("jnp", r["rx"]) if first == "jax" else ("port", r["jrx"])
    named = r[a][1][2]
    outs, _ = _steps(b, r["raw"][3:], b.import_state(named), jax_rx=first == "port")
    _assert_audio_close(outs, r[a][0][3:])


def test_short_blocks_match_one_long_block():
    """The flagship at block 2048 over 32 blocks against one step of a
    65,536-sample receiver (the stateless kernel path) over the same
    samples: the same audio within 1 LSB."""
    plan = build_plan(benchmark_config())
    raw = _short_raw(plan, 65536, 1, seed=3)
    short = CompiledReceiver(plan, 2048, device="cpu")
    long_ = CompiledReceiver(plan, 65536, device="cpu")
    assert long_.xtail_len() and long_.mix_cascades() and not short.mix_cascades()
    outs, _ = _steps(short, raw.reshape(32, 4096))
    joined = [{k: np.concatenate([o[k] for o in outs]) for k in outs[0]}]
    _assert_audio_close(joined, _steps(long_, raw)[0])


@pytest.mark.parametrize("entry", ["u8", "f32"])
@pytest.mark.parametrize("t_len", [4224, 72000])
def test_dc_plain_at_ragged_block_matches_jax(rng, entry, t_len):
    """K1's plain version at a T that is no multiple of 256 (the JAX
    package runs its jnp DC there) against that jnp DC, over two blocks."""
    from sdrreceiver_tpu.kernels import dc as jdc
    from sdrreceiver_tpu.kernels import ingest as jingest
    from sdrreceiver_tpu_torch.cuda.dckernel import dc_ingest_plain

    mean = torch.tensor([3.25, -1.5])
    jmean = jnp.asarray(mean.numpy())
    for _ in range(2):
        raw = rng.integers(0, 256, 2 * t_len).astype(np.uint8)
        if entry == "f32":
            raw = raw.astype(np.float32) - 127.0
            jx = (jnp.asarray(raw[0::2]), jnp.asarray(raw[1::2]))
        else:
            jx = jingest.u8_iq_to_planar(jnp.asarray(raw))
        mean, (yr, yi) = dc_ingest_plain(mean, torch.from_numpy(raw))
        jmean, (jyr, jyi) = jdc.dc_block_planar(jmean, jx)
        np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=1e-5, atol=1e-6)
        for a, b in ((yr, jyr), (yi, jyi)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-3)


def test_cuda_receiver_without_card_raises():
    """Decided inside the test: on a machine with a card there is nothing
    to show here."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CompiledReceiver(build_plan(benchmark_config()), BLOCK, device="cuda")


def test_receiver_defaults_to_the_card():
    """``CompiledReceiver(plan)`` runs on the card unless the caller asks
    for the CPU: without one it raises instead of falling back.  Decided
    inside the test: on a machine with a card there is nothing to show."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CompiledReceiver(build_plan(benchmark_config()), BLOCK)
    assert CompiledReceiver(build_plan(benchmark_config()), BLOCK, device="cpu").device.type == "cpu"


def test_port_never_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import sdrreceiver_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "assert len(mods) >= 44, mods\n"
        "assert {'sdrreceiver_tpu_torch.dist.' + m for m in ('halo', 'mesh', 'multihost', "
        "'sharded')} <= set(mods), mods\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'sdrreceiver_tpu.'))]\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120, check=False,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
