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
  6. the 1.92 Msps alt-rate plan (``flagship.altrate_config``) at full
     width through the CLI (``synth``, then ``process-file --device cuda``
     over 8 blocks of 480,000): launch counts, tones, kernel vs plain path,
     ``--burst 4`` vs ``--burst 1``, a save/resume split, output files
  7. the 288 ksps /6 plan through ``process-file``: tone, kernel vs plain
  8. the IQ-forwarding plan with a 156-tap (overlap-save) audio filter and
     scope taps at block 384,000: IQ bytes, overlap-save vs direct FIR,
     tap shapes, the input tap's spectrum peak
  9. alt-rate timing: the step (kernel and plain path), each mix-cascade
     site, the CLI's realtime factor, overlap-save vs direct FIR, peak
     device memory

The line before the last is a JSON summary of the kernels; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import torch

BLOCK = 1_536_000
N_BLOCKS = 4
DEVICE = "cuda"
ALT_BLOCK = 480_000
WORK = pathlib.Path(__file__).resolve().parent / "build" / "smoke"

# tests/test_altrate_e2e.py's 288 ksps plan: a mix-only group and a pure /6
# chain, no DC correction (so neither CUDA kernel runs there)
INI_288 = """
sample_rate=288000
center_frequency=1546100000
zmq_address=tcp://*:6004
[main_vfos]
size=1
1\\frequency=1546100000
1\\out_rate=288000
[vfos]
size=1
1\\frequency=1546045422
1\\gain=4
1\\data_rate=10500
1\\topic=VFO51
"""

# tests/test_receiver_e2e.py's SMALL_INI (group 1 forwards IQ on IQFWD) with
# VFO13 given a 3 kHz filter: 156 taps, so the overlap-save FFT path
IQ_INI = """
sample_rate=1536000
center_frequency=1545600000
zmq_address=tcp://*:6003
correct_dc_bias=1
[main_vfos]
size=2
1\\frequency=1545116000
1\\out_rate=384000
2\\frequency=1546096000
2\\out_rate=192000
2\\zmq_address=tcp://127.0.0.1:7777
2\\zmq_topic=IQFWD
[vfos]
size=3
1\\frequency=1545005146
1\\gain=5
1\\data_rate=600
1\\filter_bandwidth=4000
1\\topic=VFO01
2\\frequency=1545214573
2\\gain=5
2\\data_rate=600
2\\topic=VFO02
3\\frequency=1546005300
3\\gain=5
3\\data_rate=10500
3\\filter_bandwidth=3000
3\\topic=VFO13
"""
IQ_BLOCK = 384_000


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


def ini_text(cfg) -> str:
    """A ReceiverConfig as the ini the CLI reads."""
    lines = [
        f"sample_rate={cfg.sample_rate}", f"center_frequency={cfg.center_frequency}",
        f"zmq_address={cfg.zmq_address}", f"correct_dc_bias={int(cfg.correct_dc_bias)}",
        "[main_vfos]", f"size={len(cfg.main_vfos)}",
    ]
    for i, m in enumerate(cfg.main_vfos, 1):
        lines += [f"{i}\\frequency={m.frequency}", f"{i}\\out_rate={m.out_rate}"]
    lines += ["[vfos]", f"size={len(cfg.vfos)}"]
    for i, v in enumerate(cfg.vfos, 1):
        lines += [f"{i}\\frequency={v.frequency}", f"{i}\\topic={v.topic}",
                  f"{i}\\gain={v.gain}", f"{i}\\data_rate={v.data_rate}",
                  f"{i}\\filter_bandwidth={v.filter_bandwidth}"]
    return "\n".join(lines) + "\n"


def cli(*argv) -> dict:
    """Run the port's CLI in this process; returns the JSON of its last
    line of output.  Fails the script on a non-zero exit."""
    from sdrreceiver_tpu_torch.cli.main import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main([str(a) for a in argv])
    if rc != 0:
        fail(f"CLI {' '.join(str(a) for a in argv)} exited {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@contextlib.contextmanager
def receivers_built():
    """Collect every CompiledReceiver constructed inside the block (the
    CLI builds its own); their launch counts start at 0 when built."""
    from sdrreceiver_tpu_torch.graph.compiler import CompiledReceiver

    built, init = [], CompiledReceiver.__init__

    def record(self, *args, **kwargs):
        init(self, *args, **kwargs)
        built.append(self)

    CompiledReceiver.__init__ = record
    try:
        yield built
    finally:
        CompiledReceiver.__init__ = init


def read_audio(outdir: pathlib.Path) -> dict[str, np.ndarray]:
    return {p.stem[len("audio_"):]: np.fromfile(p, np.int16)
            for p in sorted(outdir.glob("audio_*.s16"))}


def audio_diff(ours: dict, ref: dict, what: str, flip_limit: float | None = 1e-3
               ) -> tuple[int, float]:
    """Worst LSB difference and pooled flip rate; fails the script above
    1 LSB or at a flip rate of ``flip_limit`` or more (None: reported
    only)."""
    if set(ours) != set(ref) or not ref:
        fail(f"{what}: topics {sorted(ours)} vs {sorted(ref)}")
    lsb, flips, total = 0, 0, 0
    for k, r in ref.items():
        if ours[k].shape != r.shape:
            fail(f"{what} {k}: shape {ours[k].shape} vs {r.shape}")
        d = np.abs(ours[k].astype(np.int32) - r.astype(np.int32))
        lsb, flips, total = max(lsb, int(d.max())), flips + int((d > 0).sum()), total + d.size
    flip = flips / total
    print(f"{what}: {len(ref)} topics, max {lsb} LSB (limit 1), flip rate {flip:.2e} "
          f"(limit {flip_limit})")
    if lsb > 1 or (flip_limit is not None and flip >= flip_limit):
        fail(f"{what} disagree")
    return lsb, flip


def check_tone(a: np.ndarray, rate: int, tone: float, what: str) -> None:
    """Peak within +-15 Hz and at least 20 dB over everything 40 Hz away."""
    a = a.astype(np.float64)
    spec = np.abs(np.fft.rfft(a * np.hanning(len(a))))
    freqs = np.fft.rfftfreq(len(a), 1.0 / rate)
    peak = freqs[np.argmax(spec)]
    margin = 20 * np.log10(spec.max() / spec[np.abs(freqs - tone) > 40].max())
    print(f"tone {what}: {tone} Hz found at {peak:.1f} Hz, margin {margin:.1f} dB "
          f"(limits +-15 Hz, 20 dB)")
    if abs(peak - tone) > 15 or margin < 20:
        fail(f"{what}: tone not found")


def nibbles(b: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Signed high (re) and low (im) nibbles of packed style-1 IQ bytes."""
    hi, lo = (b.astype(np.int32) >> 4) & 0xF, b.astype(np.int32) & 0xF
    return np.where(hi >= 8, hi - 16, hi), np.where(lo >= 8, lo - 16, lo)


def phase_altrate(dev: torch.device) -> dict:
    """6. The alt-rate plan at full width through the CLI."""
    from sdrreceiver_tpu_torch.flagship import altrate_config

    d = WORK / "alt"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    ini, iq = d / "alt.ini", d / "alt.u8"
    ini.write_text(ini_text(altrate_config()))
    tones = cli("synth", "-s", ini, "--out", iq, "--seconds", 2, "--amplitude", 5,
                "--noise", 1.0, "--only", "AL000,AL002,AH000,AH002")["tones"]
    raw = np.fromfile(iq, np.uint8)
    n_blocks = raw.size // (2 * ALT_BLOCK)
    half = n_blocks // 2 * 2 * ALT_BLOCK
    (d / "head.u8").write_bytes(raw[:half].tobytes())
    (d / "tail.u8").write_bytes(raw[half:].tobytes())
    run = ("process-file", "-s", ini, "--device", DEVICE)

    # the main path: the receiver is built inside the CLI call, its counts
    # start at 0 there and are read right after
    with receivers_built() as built:
        summary = cli(*run, "--iq", iq, "--out", d / "k", "--spectrum", "main",
                      "--save-state", d / "s.npz", "--wav")
    (rx,) = built
    sites = rx.mix_cascades()
    launches = {"dc_ingest": rx.dc_ingest.launches,
                **{f"mix_cascade {k}": mc.launches for k, (mc, _) in sites.items()}}
    print(f"alt-rate main path: {n_blocks} blocks of {rx.block}, xtail {rx.xtail_len()}, "
          f"mix-cascade sites {sorted(sites)}; launches {launches} "
          f"(expected {n_blocks} each, 2 sites)")
    if rx.block != ALT_BLOCK or len(sites) != 2 or any(n != n_blocks for n in launches.values()):
        fail("alt-rate: the main path did not launch each kernel once per block")
    kern = read_audio(d / "k")
    if len(kern) != 6 or any(v.size != n_blocks * rx.output_shapes()[f"audio/{k}"][0]
                             for k, v in kern.items()):
        fail(f"alt-rate: audio files {sorted(kern)} of the wrong length")
    for topic, tone in tones.items():
        a = kern[topic]
        check_tone(a[-len(a) // n_blocks:], rx.rates()[f"audio/{topic}"], tone, f"alt-rate {topic}")

    cli(*run, "--iq", iq, "--out", d / "p", "--plain")
    lsb, flip = audio_diff(kern, read_audio(d / "p"), "alt-rate kernel path vs plain path")
    burst = cli(*run, "--iq", iq, "--out", d / "b", "--burst", 4)
    if any(not np.array_equal(v, kern[k]) for k, v in read_audio(d / "b").items()):
        fail("alt-rate: --burst 4 differs from --burst 1")
    print("alt-rate --burst 4 vs --burst 1: bit-equal")
    cli(*run, "--iq", d / "head.u8", "--out", d / "h", "--save-state", d / "h.npz")
    cli(*run, "--iq", d / "tail.u8", "--out", d / "t", "--resume", d / "h.npz")
    tail = read_audio(d / "t")
    same = all(np.array_equal(v, kern[k][-v.size:]) for k, v in tail.items())
    audio_diff(tail, {k: v[-tail[k].size:] for k, v in kern.items()},
               f"alt-rate resume (blocks 1-{n_blocks // 2} saved, "
               f"{n_blocks // 2 + 1}-{n_blocks} resumed) vs straight run")
    print(f"alt-rate resume bit-equal to the straight run: {same}")
    spec = np.load(d / "k" / "spectrum_main.npy")
    wavs = sorted(p.name for p in (d / "k").glob("*.wav"))
    if spec.shape != (8182,) or not np.isfinite(spec).all() or len(wavs) != 6 \
            or not (d / "s.npz").exists():
        fail(f"alt-rate: output files missing ({spec.shape}, {wavs})")
    print(f"alt-rate files: spectrum_main.npy {spec.shape}, {len(wavs)} .wav, s.npz")
    return {"rx_launches": launches, "sites": sites, "summary": summary, "burst": burst,
            "raw": raw, "lsb": lsb, "flip": flip}


def phase_288() -> None:
    """7. The 288 ksps /6 plan through the CLI."""
    d = WORK / "r288"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    ini, iq = d / "r288.ini", d / "r288.u8"
    ini.write_text(INI_288)
    tones = cli("synth", "-s", ini, "--out", iq, "--seconds", 2, "--amplitude", 5,
                "--noise", 1.0)["tones"]
    run = ("process-file", "-s", ini, "--device", DEVICE, "--iq", iq, "--block", 57600)
    with receivers_built() as built:
        summary = cli(*run, "--out", d / "k")
    (rx,) = built
    print(f"288k: {summary['blocks']} blocks of {rx.block}, mix-cascade sites "
          f"{sorted(rx.mix_cascades())}, dc_ingest launches {rx.dc_ingest.launches} "
          f"(no DC correction, no cascade: torch ops only)")
    kern = read_audio(d / "k")
    for topic, tone in tones.items():
        a = kern[topic]
        check_tone(a[-len(a) // summary["blocks"]:], 48000, tone, f"288k {topic}")
    cli(*run, "--out", d / "p", "--plain")
    audio_diff(kern, read_audio(d / "p"), "288k kernel path vs plain path")


def phase_iq(dev: torch.device) -> dict:
    """8. IQ forwarding, overlap-save audio and scope taps."""
    from sdrreceiver_tpu_torch.graph.compiler import CompiledReceiver
    from sdrreceiver_tpu_torch.graph.config import parse_ini_text
    from sdrreceiver_tpu_torch.graph.plan import build_plan
    from sdrreceiver_tpu_torch.io.iqfile import synthesize_channels, to_u8
    from sdrreceiver_tpu_torch.obs.spectrum import power_spectrum

    plan = build_plan(parse_ini_text(IQ_INI))
    taps = ("main", "g0", "VFO01")
    rx = CompiledReceiver(plan, IQ_BLOCK, emit_taps=taps, device=dev)
    plain = CompiledReceiver(plan, IQ_BLOCK, emit_taps=taps, device=dev, use_kernels=False)
    direct = CompiledReceiver(plan, IQ_BLOCK, emit_taps=taps, device=dev, ossfft_min_taps=None)
    if set(rx._oss) != {"g1/b0"} or direct._oss:
        fail(f"iq plan: overlap-save banks {sorted(rx._oss)}, direct {sorted(direct._oss)}")
    carrier = 512 * plan.fs // 8192  # on an exact bin of the 8192-point scope
    subs = [s for g in plan.groups for b in g.buckets for s in b.subs]
    n_blocks = 3
    sig = synthesize_channels(
        n_blocks * IQ_BLOCK, plan.fs, plan.center_frequency,
        [(s.frequency, 700 + 37 * i, 4.0) for i, s in enumerate(subs)]
        + [(plan.center_frequency + carrier, 0.0, 30.0)],
        noise=1.0, dc_offset=3 - 2j, seed=1,
    )
    blocks = torch.tensor(to_u8(sig).reshape(n_blocks, -1), device=dev)
    outs = {}
    for name, r in (("kernel", rx), ("plain", plain), ("direct", direct)):
        st, outs[name] = r.init_state(), []
        for i in range(n_blocks):
            st, o = r.step_u8(st, blocks[i])
            outs[name].append({k: v.cpu().numpy() for k, v in r.split_audio(o).items()})
    audio = {n: {f"{i}/{k}": v for i, o in enumerate(os) for k, v in o.items()
                 if k.startswith("audio/")} for n, os in outs.items()}
    audio_diff(audio["kernel"], audio["plain"], "iq plan kernel path vs plain path")
    # an FFT rounds in other places than a direct sum: the bar is 1 LSB
    audio_diff(audio["kernel"], audio["direct"], "iq plan overlap-save vs direct FIR (156 taps)",
               flip_limit=None)
    worst = 0.0
    for ko, po in zip(outs["kernel"], outs["plain"]):
        a, b = ko["iq/IQFWD"], po["iq/IQFWD"]
        share = float((a != b).mean())
        step = max(int(np.abs(x - y).max()) for x, y in zip(nibbles(a), nibbles(b)))
        worst = max(worst, share)
        if a.dtype != np.uint8 or a.shape != (IQ_BLOCK >> 3,) or share >= 1e-3 or step > 1:
            fail(f"iq/IQFWD kernel vs plain: {a.dtype} {a.shape}, {share:.2e} of bytes, "
                 f"{step} nibble steps")
    print(f"iq/IQFWD uint8 [{IQ_BLOCK >> 3}] kernel vs plain: worst {worst:.2e} of bytes differ "
          f"(limit 1e-3), at most one nibble step")
    last = outs["kernel"][-1]
    want = {"main": 8192, "g0": 8192, "VFO01": (IQ_BLOCK >> 2) >> 5}
    shapes = {t: last[f"tap/{t}"].shape for t in taps}
    print(f"tap shapes {shapes} (the last min(8192, T') samples)")
    if any(shapes[t] != (2, n) for t, n in want.items()):
        fail("tap shapes")
    peak = int(torch.argmax(power_spectrum(torch.tensor(last["tap/main"], device=dev))))
    print(f"power_spectrum(tap/main) peak bin {peak}, carrier bin {4096 + 512}")
    if peak != 4096 + 512:
        fail("tap/main spectrum does not peak at the carrier")
    return {"rx": rx, "direct": direct}


def phase_alt_timing(dev, card: str, alt: dict, iqr: dict, reps: int) -> dict:
    """9. Alt-rate step and kernels on the card; overlap-save vs direct."""
    from sdrreceiver_tpu_torch.cuda.dckernel import DcIngest
    from sdrreceiver_tpu_torch.flagship import altrate_config
    from sdrreceiver_tpu_torch.graph.compiler import CompiledReceiver
    from sdrreceiver_tpu_torch.graph.plan import build_plan
    from sdrreceiver_tpu_torch.kernels import fir, ossfft

    plan = build_plan(altrate_config())
    rx = CompiledReceiver(plan, ALT_BLOCK, device=dev)
    rx_plain = CompiledReceiver(plan, ALT_BLOCK, device=dev, use_kernels=False)
    raw = alt["raw"]
    n = raw.size // (2 * ALT_BLOCK)
    f32 = torch.tensor(raw.astype(np.float32) - 127.0, device=dev).reshape(n, -1)
    rng = np.random.default_rng(3)
    out = {"sites": {}}
    dck = DcIngest()
    mean = torch.tensor([3.25, -1.5], device=dev)
    m_k, (yr_k, yi_k) = dck(mean, f32[0])
    m_p, (yr_p, yi_p) = dck.plain(mean, f32[0])
    out["dc_err"] = max((yr_k - yr_p).abs().max().item(), (yi_k - yi_p).abs().max().item())
    mrel = ((m_k - m_p).abs() / m_p.abs()).max().item()
    print(f"kernel dc_ingest f32 T={ALT_BLOCK}: y max_abs_err={out['dc_err']:.3e} (limit 1e-3), "
          f"mean rel_err={mrel:.3e} (limit 1e-4)")
    if not out["dc_err"] <= 1e-3 or not mrel <= 1e-4:
        fail("dc_ingest f32 disagrees with its plain version at the alt-rate block")
    out["dc_plain_ms"], out["dc_ms"] = in_turns(
        lambda: dck.plain(mean, f32[0]), lambda: dck(mean, f32[0]), reps)
    print(f"time dc_ingest f32 T={ALT_BLOCK}: kernel {out['dc_ms']:.4f} ms, "
          f"plain {out['dc_plain_ms']:.4f} ms {card}")
    out["mc_err"] = out["mc_ms"] = out["mc_plain_ms"] = 0.0
    for name, (mc, t_len) in rx.mix_cascades().items():
        xr = torch.tensor(rng.uniform(-128, 128, (1, t_len)).astype(np.float32), device=dev)
        xi = torch.tensor(rng.uniform(-128, 128, (1, t_len)).astype(np.float32), device=dev)
        ph = torch.tensor(rng.integers(0, mc.fs, mc.channels), device=dev)
        yr_k, yi_k = mc(ph, xr, xi)
        yr_p, yi_p = mc.plain(ph, xr, xi)
        err = max((yr_k - yr_p).abs().max().item(), (yi_k - yi_p).abs().max().item())
        if not err <= 2e-3:
            fail(f"alt-rate mix_cascade {name} disagrees with its plain version")
        p, k = in_turns(lambda: mc.plain(ph, xr, xi), lambda: mc(ph, xr, xi), reps)
        out["sites"][name] = (k, p)
        out["mc_err"] = max(out["mc_err"], err)
        out["mc_ms"] += k
        out["mc_plain_ms"] += p
        print(f"alt-rate mix_cascade {name}: C={mc.channels} depths={sorted(set(mc.depths))} "
              f"T={t_len} max_abs_err={err:.3e} (limit 2e-3); kernel {k:.4f} ms, "
              f"plain {p:.4f} ms {card}")

    torch.cuda.reset_peak_memory_stats()
    st = {"k": rx.init_state(), "p": rx_plain.init_state(), "i": 0}

    def step(r, key):
        def go():
            i = st["i"] = (st["i"] + 1) % n
            st[key], _ = r.step_f32(st[key], f32[i])
        return go

    for _ in range(3):
        step(rx, "k")()
    plain_ms, kern_ms = in_turns(step(rx_plain, "p"), step(rx, "k"), reps)
    peak = torch.cuda.max_memory_allocated()
    print(f"alt-rate step_f32 block={ALT_BLOCK} in turns: kernel path {kern_ms:.3f} ms "
          f"(realtime x{1000.0 * ALT_BLOCK / plan.fs / kern_ms:.1f}), plain path "
          f"{plain_ms:.3f} ms {card}")
    print(f"alt-rate peak device memory (both paths' steps): {peak / 2**20:.1f} MiB {card}")
    for key, summ in (("--burst 1", alt["summary"]), ("--burst 4", alt["burst"])):
        print(f"alt-rate process-file {key}: realtime factor {summ['realtime_factor']} "
              f"({summ['msamples_per_second']} Msamples/s, {summ['blocks']} blocks, "
              f"first block included) {card}")

    irx, idir = iqr["rx"], iqr["direct"]
    filt, rt = irx._oss["g1/b0"], idir._c["g1/b0/audio"]
    t_audio = (IQ_BLOCK >> 3) >> 2
    x = torch.tensor(rng.standard_normal((1, t_audio)).astype(np.float32), device=dev)
    h = torch.zeros(1, filt["ntaps"] - 1, device=dev)
    direct_ms, oss_ms = in_turns(lambda: fir.conv_block(h, x, rt),
                                 lambda: ossfft.oss_block(h, x, filt), reps)
    print(f"156-tap audio bank on [1, {t_audio}]: overlap-save {oss_ms:.4f} ms, direct "
          f"conv_block {direct_ms:.4f} ms {card}")
    return out


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

    # ---- 6-9. the rest of the single-device receiver ----
    alt = phase_altrate(dev)
    phase_288()
    iqr = phase_iq(dev)
    at = phase_alt_timing(dev, card, alt, iqr, reps)
    alt_mc = sum(n for k, n in alt["rx_launches"].items() if k.startswith("mix_cascade"))

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
        {"name": "dc_ingest (alt-rate f32 entry, T=480000)", "route": "cuda",
         "source": "sdrreceiver_tpu_torch/csrc/dc_ingest.cu",
         "replaces": "sdrreceiver_tpu/pallas/dckernel.py:176",
         "launches": alt["rx_launches"]["dc_ingest"], "max_abs_err": at["dc_err"],
         "ms": at["dc_ms"], "plain_ms": at["dc_plain_ms"]},
        {"name": "mix_cascade (alt-rate: front C=2 d=[3,3], g0/b0 C=3 d=2)", "route": "cuda",
         "source": "sdrreceiver_tpu_torch/csrc/mix_cascade.cu",
         "replaces": "sdrreceiver_tpu/pallas/frontend.py:488",
         "also_replaces": "sdrreceiver_tpu/pallas/frontend.py:672",
         "launches": alt_mc, "max_abs_err": at["mc_err"],
         "ms": at["mc_ms"], "plain_ms": at["mc_plain_ms"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
