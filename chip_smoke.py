"""Drive the PyTorch/CUDA port of the receiver on one NVIDIA GPU.

    python3 chip_smoke.py

Needs a CUDA device, the CUDA toolkit (nvcc) and this repository's
``sdrreceiver_tpu_torch`` package; imports no JAX.  Phases, each printing
its result and failing the script (non-zero exit) if it fails:

  1. device: ``nvidia-smi`` name and power limit, torch and CUDA versions
  2. build: nvcc builds every kernel from ``csrc/``; the ptxas report
  3. each kernel against its plain PyTorch version at the flagship shapes
  4. the flagship receiver end to end (4 blocks of 1.536 Msamples of u8
     IQ): kernel path vs plain path, tones found in the audio, and the
     kernels' launch counts in the main path's run
  5. timing with CUDA events: step, each kernel and its plain version, in
     turns (plain, kernel, kernel, plain); peak device memory

The line before the last is a JSON summary of the kernels; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch

BLOCK = 1_536_000
N_BLOCKS = 4
DEVICE = "cuda"


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` calls (after one
    warm-up call), between two CUDA events."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def in_turns(plain, kernel, reps: int) -> tuple[float, float]:
    """(plain ms, kernel ms), timed plain, kernel, kernel, plain."""
    p1 = cuda_ms(plain, reps)
    k1 = cuda_ms(kernel, reps)
    k2 = cuda_ms(kernel, reps)
    p2 = cuda_ms(plain, reps)
    return (p1 + p2) / 2, (k1 + k2) / 2


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    card = f"[{smi}]"

    from sdrreceiver_tpu_torch.cuda import build
    from sdrreceiver_tpu_torch.cuda.dckernel import DcIngest
    from sdrreceiver_tpu_torch.cuda.frontend import MixCascade
    from sdrreceiver_tpu_torch.flagship import benchmark_config
    from sdrreceiver_tpu_torch.graph.compiler import CompiledReceiver
    from sdrreceiver_tpu_torch.graph.plan import build_plan
    from sdrreceiver_tpu_torch.io.iqfile import synthesize_channels, to_u8

    # ---- 1. device ----
    print(smi)
    print(f"device: {torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} "
          f"torch={torch.__version__} cuda={torch.version.cuda}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(DEVICE)

    # ---- 2. build ----
    build.library()
    print("build: ok; ptxas report:")
    for line in build.ptxas_report().splitlines():
        if line.strip():
            print("  " + line.strip())

    plan = build_plan(benchmark_config())
    rx = CompiledReceiver(plan, BLOCK, device=dev)
    rx_plain = CompiledReceiver(plan, BLOCK, device=dev, use_kernels=False)
    rng = np.random.default_rng(0)

    # ---- 3. kernels vs plain versions at flagship shapes ----
    dck = DcIngest()
    raw_u8 = torch.tensor(rng.integers(0, 256, 2 * BLOCK, dtype=np.uint8), device=dev)
    raw_f32 = raw_u8.float() - 127.0
    mean = torch.tensor([3.25, -1.5], dtype=torch.float32, device=dev)
    dc_err = 0.0
    for name, raw in (("u8", raw_u8), ("f32", raw_f32)):
        m_k, (yr_k, yi_k) = dck(mean, raw)
        m_p, (yr_p, yi_p) = dck.plain(mean, raw)
        err = max((yr_k - yr_p).abs().max().item(), (yi_k - yi_p).abs().max().item())
        mrel = ((m_k - m_p).abs() / m_p.abs()).max().item()
        dc_err = max(dc_err, err)
        print(f"kernel dc_ingest {name} T={BLOCK}: y max_abs_err={err:.3e} (limit 1e-3), "
              f"mean rel_err={mrel:.3e} (limit 1e-4)")
        if not err <= 1e-3 or not mrel <= 1e-4:
            fail(f"dc_ingest {name} disagrees with its plain version")

    sites = rx.mix_cascades()
    if len(sites) != 4:
        fail(f"expected 4 mix-cascade sites on the flagship, got {sorted(sites)}")
    # beyond the main path's four: one input row per channel (the JAX
    # grid form's other mode) at depth 7, the largest shared-memory tile
    extra = MixCascade([7, 3], plan.fs, [484000, -496000], dev)
    mc_err = 0.0
    mc_inputs = []
    for name, (mc, t_len) in [*sites.items(), ("per-channel input", (extra, 1 << 16))]:
        n_in = mc.channels if mc is extra else 1
        xr = torch.tensor(rng.uniform(-128, 128, (n_in, t_len)).astype(np.float32), device=dev)
        xi = torch.tensor(rng.uniform(-128, 128, (n_in, t_len)).astype(np.float32), device=dev)
        ph = torch.tensor(rng.integers(0, mc.fs, mc.channels), device=dev)
        yr_k, yi_k = mc(ph, xr, xi)
        yr_p, yi_p = mc.plain(ph, xr, xi)
        err = max((yr_k - yr_p).abs().max().item(), (yi_k - yi_p).abs().max().item())
        print(f"kernel mix_cascade {name}: C={mc.channels} depths={sorted(set(mc.depths))} "
              f"T={t_len} max_abs_err={err:.3e} (limit 2e-3)")
        if not err <= 2e-3:
            fail(f"mix_cascade {name} disagrees with its plain version")
        if mc is not extra:
            mc_err = max(mc_err, err)
            mc_inputs.append((name, mc, ph, xr, xi))
    torch.cuda.synchronize()

    # ---- 4. flagship end to end ----
    subs = sorted(
        (s for g in plan.groups for b in g.buckets for s in b.subs),
        key=lambda s: s.config_index,
    )
    tones = {s.topic: 500 + 37 * i for i, s in enumerate(subs) if i % 3 == 0}
    iq = synthesize_channels(
        N_BLOCKS * BLOCK, plan.fs, plan.center_frequency,
        [(s.frequency, tones[s.topic], 4.0) for s in subs if s.topic in tones],
        noise=1.0, seed=0,
    )
    blocks = torch.tensor(to_u8(iq).reshape(N_BLOCKS, 2 * BLOCK), device=dev)
    mcs = [mc for mc, _ in sites.values()]
    for w in (rx.dc_ingest, *mcs):
        w.launches = 0
    state = rx.init_state()
    kern_out = []
    for i in range(N_BLOCKS):
        state, out = rx.step_u8(state, blocks[i])
        kern_out.append(rx.split_audio(out))
    torch.cuda.synchronize()
    dc_launches = rx.dc_ingest.launches
    mc_launches = [mc.launches for mc in mcs]
    print(f"main path launches over {N_BLOCKS} steps: dc_ingest={dc_launches} "
          f"mix_cascade={mc_launches} (expected {N_BLOCKS} and 4 x {N_BLOCKS})")
    if dc_launches != N_BLOCKS or any(n != N_BLOCKS for n in mc_launches):
        fail("the main path did not launch each kernel once per instance per step")

    pstate = rx_plain.init_state()
    worst_lsb, worst_flip = 0, 0.0
    shapes = rx.output_shapes()
    for i in range(N_BLOCKS):
        pstate, pout = rx_plain.step_u8(pstate, blocks[i])
        plain_audio = rx_plain.split_audio(pout)
        for k, v in kern_out[i].items():
            if v.shape != shapes[k] or v.dtype != torch.int16:
                fail(f"{k}: {v.dtype} {tuple(v.shape)}, expected int16 {shapes[k]}")
            d = (v.int() - plain_audio[k].int()).abs()
            lsb, flip = d.max().item(), (d > 0).float().mean().item()
            worst_lsb, worst_flip = max(worst_lsb, lsb), max(worst_flip, flip)
            if lsb > 1 or flip >= 1e-3:
                fail(f"block {i} {k}: kernel vs plain {lsb} LSB, flip rate {flip:.2e}")
    print(f"kernel path vs plain path, {len(shapes)} topics x {N_BLOCKS} blocks: "
          f"max {worst_lsb} LSB (limit 1), worst flip rate {worst_flip:.2e} (limit 1e-3)")

    last = kern_out[-1]
    for topic, tone in tones.items():
        a = last[f"audio/{topic}"].double().cpu().numpy()
        rate = rx.rates()[f"audio/{topic}"]
        spec = np.abs(np.fft.rfft(a * np.hanning(len(a))))
        freqs = np.fft.rfftfreq(len(a), 1.0 / rate)
        peak = freqs[np.argmax(spec)]
        far = np.abs(freqs - tone) > 40
        margin = 20 * np.log10(spec.max() / spec[far].max())
        print(f"tone {topic}: {tone} Hz found at {peak:.1f} Hz, margin {margin:.1f} dB "
              f"(limits +-15 Hz, 20 dB)")
        if abs(peak - tone) > 15 or margin < 20:
            fail(f"{topic}: tone not found")

    # ---- 5. timing ----
    reps = 20
    torch.cuda.reset_peak_memory_stats()
    step_state = {"k": rx.init_state(), "p": rx_plain.init_state(), "i": 0}

    def step(r, key):
        def run():
            i = step_state["i"] = (step_state["i"] + 1) % N_BLOCKS
            step_state[key], _ = r.step_u8(step_state[key], blocks[i])
        return run

    for _ in range(3):
        step(rx, "k")()
    torch.cuda.synchronize()
    step_ms = cuda_ms(step(rx, "k"), reps)
    peak = torch.cuda.max_memory_allocated()
    plain_step_ms, kern_step_ms = in_turns(step(rx_plain, "p"), step(rx, "k"), reps)
    msps = BLOCK / step_ms / 1e3
    print(f"step_u8 block={BLOCK}: {step_ms:.3f} ms/step, {msps:.1f} Msamples/s, "
          f"realtime x{1000.0 * BLOCK / plan.fs / step_ms:.1f} {card}")
    print(f"step_u8 in turns: kernel path {kern_step_ms:.3f} ms, plain path "
          f"{plain_step_ms:.3f} ms {card}")
    print(f"peak device memory (kernel-path steps): {peak / 2**20:.1f} MiB {card}")

    dc_plain_ms, dc_ms = in_turns(
        lambda: dck.plain(mean, raw_u8), lambda: dck(mean, raw_u8), reps
    )
    print(f"time dc_ingest u8 T={BLOCK}: kernel {dc_ms:.4f} ms, plain {dc_plain_ms:.4f} ms {card}")
    mc_ms = mc_plain_ms = 0.0
    for name, mc, ph, xr, xi in mc_inputs:
        p, k = in_turns(lambda: mc.plain(ph, xr, xi), lambda: mc(ph, xr, xi), reps)
        mc_ms += k
        mc_plain_ms += p
        print(f"time mix_cascade {name}: kernel {k:.4f} ms, plain {p:.4f} ms {card}")

    kernels = [
        {"name": "dc_ingest", "route": "cuda",
         "source": "sdrreceiver_tpu_torch/csrc/dc_ingest.cu",
         "replaces": "sdrreceiver_tpu/pallas/dckernel.py:176",
         "launches": dc_launches, "max_abs_err": dc_err,
         "ms": dc_ms, "plain_ms": dc_plain_ms},
        {"name": "mix_cascade", "route": "cuda",
         "source": "sdrreceiver_tpu_torch/csrc/mix_cascade.cu",
         "replaces": "sdrreceiver_tpu/pallas/frontend.py:488",
         "also_replaces": "sdrreceiver_tpu/pallas/frontend.py:672",
         "launches": sum(mc_launches), "max_abs_err": mc_err,
         "ms": mc_ms, "plain_ms": mc_plain_ms},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
