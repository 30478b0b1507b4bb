"""The CUDA kernels' plain versions vs the JAX package's Pallas kernels.

The Pallas kernels run as the JAX package's own tests run them: in
interpret mode on the CPU.  The hand-written CUDA kernels cannot run here
(no card, no nvcc); ``chip_smoke.py`` holds each to its plain version on
the card.  What runs here: the plain versions against Pallas, and the
wrappers' CPU dispatch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdrreceiver_tpu.kernels import ingest as jingest
from sdrreceiver_tpu.pallas import frontend as jfrontend
from sdrreceiver_tpu.pallas.dckernel import DcKernel
from sdrreceiver_tpu.pallas.frontend import MixCascadeKernel
from sdrreceiver_tpu_torch.cuda import frontend
from sdrreceiver_tpu_torch.cuda.dckernel import DcIngest, dc_ingest_plain
from sdrreceiver_tpu_torch.cuda.frontend import MixCascade, mix_cascade_plain
from sdrreceiver_tpu_torch.flagship import benchmark_config
from sdrreceiver_tpu_torch.graph.plan import build_plan

# six xdist workers share the machine's cores: a few torch threads each
torch.set_num_threads(2)


@pytest.mark.parametrize("stages", range(8))
def test_composite_taps_and_warmup_exact(stages):
    np.testing.assert_array_equal(
        frontend.composite_taps(stages), jfrontend.composite_taps(stages)
    )
    assert frontend.warmup_len(stages) == jfrontend.warmup_len(stages)


def test_phase_back_exact():
    fs = 384000
    freqs = np.array([110854, -95000, 0, 383999])
    k = MixCascadeKernel(4, 2, fs, freqs, 256 * 16, interpret=True)
    phase = np.array([0, 5, 383999, 12345], np.uint32)
    ours = frontend.phase_back(
        torch.tensor(phase.astype(np.int64)), torch.tensor(np.mod(freqs, fs)), fs, 2304
    )
    np.testing.assert_array_equal(
        ours.numpy(), np.asarray(k.phase_back(jnp.asarray(phase), 2304)).astype(np.int64)
    )


# ------------------------------------------------------------------- K1
@pytest.mark.parametrize("entry", ["u8", "f32"])
def test_dc_plain_matches_pallas_three_blocks(rng, entry):
    """K1's plain version vs DcKernel (interpret) over 3 consecutive blocks
    with the mean carried; 3 tiles of 400 rows per block."""
    t_len = 256 * 1200
    kern = DcKernel(t_len, interpret=True,
                    in_dtype=jnp.int8 if entry == "u8" else jnp.float32)
    mean = torch.tensor([2.5, -1.25])
    jmean = jnp.asarray(mean.numpy())
    for _ in range(3):
        raw = rng.integers(0, 256, 2 * t_len).astype(np.uint8)
        raw[0::2] = np.clip(raw[0::2].astype(int) // 4 + 140, 0, 255)  # a DC offset on I
        if entry == "u8":
            jin = jingest.u8_iq_to_i8_planar(jnp.asarray(raw))
            ours_in = torch.from_numpy(raw)
        else:
            f = raw.astype(np.float32) - 127.0
            jin = jingest.f32_pairs_to_planar(jnp.asarray(f))
            ours_in = torch.from_numpy(f)
        mean, (yr, yi) = dc_ingest_plain(mean, ours_in)
        jmean, (jyr, jyi) = kern(jmean, jin)
        np.testing.assert_allclose(yr.numpy(), np.asarray(jyr), rtol=0, atol=1e-4)
        np.testing.assert_allclose(yi.numpy(), np.asarray(jyi), rtol=0, atol=1e-4)
        np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=1e-5, atol=0)


# ---------------------------------------------------------------- K2/K3
def _flagship_cases():
    """The four flagship mix-cascade instances: (name, depths, fs, freqs,
    the JAX form expected)."""
    plan = build_plan(benchmark_config())
    g0, g1 = plan.groups
    return [
        ("merged", [g0.stages, g1.stages], plan.fs,
         [g0.mixer_freq, g1.mixer_freq], "chanloop"),
        ("g0/b0", [g0.buckets[0].stages], g0.out_rate,
         g0.buckets[0].mixer_freqs(), "grid"),
        ("g0/b1", [g0.buckets[1].stages] * 11, g0.out_rate,
         g0.buckets[1].mixer_freqs(), "chanloop"),
        ("g1/b0", [g1.buckets[0].stages] * 15, g1.out_rate,
         g1.buckets[0].mixer_freqs(), "chanloop"),
    ]


@pytest.mark.parametrize("case", range(4), ids=["merged", "g0_b0", "g0_b1", "g1_b0"])
def test_mix_cascade_plain_matches_pallas(rng, case):
    """K2/K3's plain version vs MixCascadeKernel (interpret) in each
    flagship configuration; inputs in +-128, atol 2e-3."""
    name, depths, fs, freqs, form = _flagship_cases()[case]
    t_len = 256 * 32
    c = len(depths)
    multi = len(set(depths)) > 1 or name == "merged"
    kern = MixCascadeKernel(
        c, depths if multi else depths[0], fs, np.asarray(freqs, np.int64), t_len,
        interpret=True, shared_input=True,
    )
    chanloop = kern.shared_input and kern.c > 1 and (kern.n_tiles == 1 or kern.c <= 8)
    assert ("chanloop" if chanloop else "grid") == form
    x = rng.uniform(-128, 128, (2, 1, t_len)).astype(np.float32)
    phase = rng.integers(0, fs, c)
    jr, ji = kern(jnp.asarray(phase.astype(np.uint32)), jnp.asarray(x[0]), jnp.asarray(x[1]))
    mc = MixCascade(depths, fs, freqs, "cpu")
    yr, yi = mix_cascade_plain(
        torch.from_numpy(phase), torch.from_numpy(x[0]), torch.from_numpy(x[1]),
        depths, fs, mc.f_mod,
    )
    for ci, (ar, ai) in enumerate(zip(mc.split(yr, t_len), mc.split(yi, t_len))):
        if multi:  # JAX pads every channel to the widest output; slice it
            l_c = kern.lanes >> depths[ci]
            rr = np.asarray(jr)[ci, :, :l_c].reshape(-1)
            ri = np.asarray(ji)[ci, :, :l_c].reshape(-1)
        else:
            rr, ri = np.asarray(jr)[ci], np.asarray(ji)[ci]
        np.testing.assert_allclose(ar.numpy(), rr, rtol=0, atol=2e-3)
        np.testing.assert_allclose(ai.numpy(), ri, rtol=0, atol=2e-3)


def test_mix_cascade_per_channel_input(rng):
    """K3's per-channel-input form: one input row per channel equals
    running each row alone as a shared input."""
    depths, fs, freqs = [3, 3], 384000, [110854, -95000]
    x = rng.uniform(-128, 128, (2, 2, 2048)).astype(np.float32)
    phase = torch.tensor([17, 383000])
    mc = MixCascade(depths, fs, freqs, "cpu")
    yr, yi = mc(phase, torch.from_numpy(x[0]), torch.from_numpy(x[1]))
    for c in range(2):
        one = MixCascade([3], fs, [freqs[c]], "cpu")
        r1, i1 = one(phase[c : c + 1], torch.from_numpy(x[0, c : c + 1]), torch.from_numpy(x[1, c : c + 1]))
        np.testing.assert_array_equal(mc.split(yr, 2048)[c].numpy(), r1.numpy())
        np.testing.assert_array_equal(mc.split(yi, 2048)[c].numpy(), i1.numpy())


# -------------------------------------------------------------- wrappers
def test_wrappers_take_plain_version_on_cpu(rng):
    """CPU tensors take the plain version and count no launch."""
    dck = DcIngest()
    raw = torch.from_numpy(rng.integers(0, 256, 1024).astype(np.uint8))
    mean = torch.zeros(2)
    m1, (a1, b1) = dck(mean, raw)
    m2, (a2, b2) = dc_ingest_plain(mean, raw)
    assert dck.launches == 0
    for p, q in ((m1, m2), (a1, a2), (b1, b2)):
        assert torch.equal(p, q)
    mc = MixCascade([2, 3], 1536000, [484000, -496000], "cpu")
    x = torch.from_numpy(rng.uniform(-1, 1, (2, 1, 512)).astype(np.float32))
    out = mc(torch.tensor([3, 4]), x[0], x[1])
    ref = mc.plain(torch.tensor([3, 4]), x[0], x[1])
    assert mc.launches == 0
    assert all(torch.equal(p, q) for p, q in zip(out, ref))
    assert mc.out_lens(512) == [128, 64] and out[0].shape == (192,)


def test_wrappers_refuse_other_devices():
    """A tensor on neither the CPU nor a CUDA device is refused, never
    routed to the plain version."""
    dck = DcIngest()
    with pytest.raises(ValueError, match="unsupported device"):
        dck(torch.zeros(2, device="meta"), torch.zeros(1024, dtype=torch.uint8, device="meta"))
    mc = MixCascade([2], 192000, [1000], "cpu")
    x = torch.zeros(1, 256, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        mc(torch.zeros(1, dtype=torch.int64, device="meta"), x, x)
    assert dck.launches == 0 and mc.launches == 0


def test_cuda_tensor_without_card_raises():
    """Asking for a CUDA tensor without a card raises; nothing falls back
    to the CPU.  (Decided here, not at import: on a machine with a card
    this test has nothing to show.)"""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        MixCascade([2], 192000, [1000], "cuda")
