"""Drive the PyTorch/CUDA port of the receiver on one NVIDIA GPU.

    python3 chip_smoke.py

Needs a CUDA device, the CUDA toolkit (nvcc) and this repository's
``sdrreceiver_tpu_torch`` package; imports no JAX.  Phases, each printing
its result and failing the script (non-zero exit) if it fails:

  1. device: ``nvidia-smi`` name and power limit, torch and CUDA versions
  2. build: nvcc builds every kernel from ``csrc/``; the ptxas report
  3. each kernel against its plain PyTorch version at the flagship shapes;
     each kernel's device time (``torch.profiler``, 50 calls) at the
     flagship, live (384,000), alt-rate (f32 480,000) and ragged shapes,
     beside its bound and its share of the bound; one ``dc_`` kernel and one
     ``mix_cascade`` kernel per call
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
 10. block sizes: the DC kernel against its plain version at T = 4224 and
     72,000 (no multiple of 256); the flagship at block 2048 (no carried
     tail: no mix-cascade, the stateful cascade) against one 65,536-sample
     step and against its plain path, with its step time; the flagship
     through ``process-file --block 4224``; the 288 ksps plan with DC
     correction at block 72,000 (Fs/4; its own block is 57,600)
 11. live ``run`` from a loopback rtl_tcp server at the flagship's own
     block of 384,000: paced at 1.536 Msps (startup commands, no drop, no
     reconnect, launches per block, ZMQ frames bit-equal to ``step_u8`` on
     the same bytes, tones, a UDP retune reaching the server), then
     unpaced (the live path's Msamples/s)
 12. ``run --iq --scope main --control-port``, paced: no block behind
     realtime, the control socket's stats / set_scope / set_fft / spectrum
     and an unknown tap; the step with every tap compiled in vs none
 13. local USB through the librtlsdr stub (``tests/fake_librtlsdr.cpp``,
     built with g++): ``devices``, then ``run`` finds the stub's tone as
     1 kHz audio, sets the bias tee and closes the device
 14. ``bench`` on the flagship, kernel path and ``--plain`` in turns, at
     blocks 384,000 and 1,536,000

The line before the last is a JSON summary of the kernels; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import ctypes
import io
import json
import os
import pathlib
import shutil
import socket
import struct
import subprocess
import sys
import threading
import time

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
LIVE_BLOCK = 384_000  # the reference's Fs/4 buffer, run's default on the flagship
REPO = pathlib.Path(__file__).resolve().parent


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


def free_port(kind=socket.SOCK_STREAM) -> int:
    with socket.socket(socket.AF_INET, kind) as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def flagship_ini(zport: int, remote: str = "") -> str:
    from sdrreceiver_tpu_torch.flagship import benchmark_config

    text = ini_text(benchmark_config()).replace("tcp://*:6003", f"tcp://127.0.0.1:{zport}")
    return (f"remote_rtl={remote}\n" if remote else "") + text


def flagship_stream(n_blocks: int, block: int, seed: int = 0):
    """(u8 ``[n_blocks, 2*block]``, {topic: tone Hz}): tones at amplitude 4
    in every third topic, noise 1.0, as in phase 4."""
    from sdrreceiver_tpu_torch.flagship import benchmark_config
    from sdrreceiver_tpu_torch.graph.plan import build_plan
    from sdrreceiver_tpu_torch.io.iqfile import synthesize_channels, to_u8

    plan = build_plan(benchmark_config())
    subs = sorted((s for g in plan.groups for b in g.buckets for s in b.subs),
                  key=lambda s: s.config_index)
    tones = {s.topic: 500 + 37 * i for i, s in enumerate(subs) if i % 3 == 0}
    iq = synthesize_channels(
        n_blocks * block, plan.fs, plan.center_frequency,
        [(s.frequency, tones[s.topic], 4.0) for s in subs if s.topic in tones],
        noise=1.0, seed=seed,
    )
    return to_u8(iq).reshape(n_blocks, 2 * block), tones


def kernel_vs_plain_dc(dev, t_len: int, kind: str, rng, reps: int, card: str):
    """K1 against its plain version at ``t_len`` with the phase-3 limits;
    (max_abs_err, kernel ms, plain ms)."""
    from sdrreceiver_tpu_torch.cuda.dckernel import DcIngest

    dck = DcIngest()
    raw = torch.tensor(rng.integers(0, 256, 2 * t_len, dtype=np.uint8), device=dev)
    if kind == "f32":
        raw = raw.float() - 127.0
    mean = torch.tensor([3.25, -1.5], dtype=torch.float32, device=dev)
    m_k, (yr_k, yi_k) = dck(mean, raw)
    m_p, (yr_p, yi_p) = dck.plain(mean, raw)
    err = max((yr_k - yr_p).abs().max().item(), (yi_k - yi_p).abs().max().item())
    mrel = ((m_k - m_p).abs() / m_p.abs()).max().item()
    plain_ms, ms = in_turns(lambda: dck.plain(mean, raw), lambda: dck(mean, raw), reps)
    print(f"kernel dc_ingest {kind} T={t_len} ({t_len % 256} past a multiple of 256): "
          f"y max_abs_err={err:.3e} (limit 1e-3), mean rel_err={mrel:.3e} (limit 1e-4); "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms {card}")
    if not err <= 1e-3 or not mrel <= 1e-4:
        fail(f"dc_ingest {kind} T={t_len} disagrees with its plain version")
    return err, ms, plain_ms


def path_launches(rx) -> dict[str, int]:
    """Launch counts of every kernel wrapper on ``rx``'s path."""
    out = {"dc_ingest": rx.dc_ingest.launches} if rx.plan.dc_correct else {}
    out.update({f"mix_cascade {k}": mc.launches for k, (mc, _) in rx.mix_cascades().items()})
    return out


def steps_audio(rx, blocks) -> list[dict]:
    """Per-block audio (host numpy) of ``rx`` stepped over u8 ``blocks``."""
    st, out = rx.init_state(), []
    for b in blocks:
        st, o = rx.step_u8(st, b)
        out.append({k: v.cpu().numpy() for k, v in rx.split_audio(o).items()})
    return out


def joined(outs: list[dict]) -> dict:
    return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}


def phase_blocks(dev, card: str, reps: int) -> dict:
    """10. The two block-size faults, closed."""
    from sdrreceiver_tpu_torch.flagship import benchmark_config
    from sdrreceiver_tpu_torch.graph.compiler import CompiledReceiver
    from sdrreceiver_tpu_torch.graph.config import parse_ini_text
    from sdrreceiver_tpu_torch.graph.plan import build_plan

    rng = np.random.default_rng(10)
    out = {"err": 0.0}
    for t_len in (4224, 72_000):
        for kind in ("u8", "f32"):
            err, ms, plain_ms = kernel_vs_plain_dc(dev, t_len, kind, rng, reps, card)
            out["err"] = max(out["err"], err)
            out[(t_len, kind)] = (ms, plain_ms)

    plan = build_plan(benchmark_config())
    short = CompiledReceiver(plan, 2048, device=dev)
    short_plain = CompiledReceiver(plan, 2048, device=dev, use_kernels=False)
    long_ = CompiledReceiver(plan, 65_536, device=dev)
    raw, tones = flagship_stream(1, 65_536, seed=10)
    raw = torch.tensor(raw, device=dev)
    blocks = raw.reshape(32, 2 * 2048)
    short.dc_ingest.launches = 0
    kern = steps_audio(short, blocks)
    torch.cuda.synchronize()
    print(f"flagship block 2048: xtail {short.xtail_len()}, mix-cascade sites "
          f"{sorted(short.mix_cascades())}; over 32 blocks dc_ingest launches "
          f"{short.dc_ingest.launches} (expected 32), no mix-cascade")
    if short.xtail_len() or short.mix_cascades() or short.dc_ingest.launches != 32:
        fail("flagship at block 2048: not the short-block path")
    audio_diff(joined(kern), joined(steps_audio(long_, raw)),
               "flagship 32 blocks of 2048 vs one block of 65,536", flip_limit=None)
    audio_diff({f"{i}/{k}": v for i, o in enumerate(kern) for k, v in o.items()},
               {f"{i}/{k}": v for i, o in enumerate(steps_audio(short_plain, blocks))
                for k, v in o.items()},
               "flagship block 2048 kernel path vs plain path")
    st = {"s": short.init_state(), "i": 0}

    def step():
        st["i"] = (st["i"] + 1) % 32
        st["s"], _ = short.step_u8(st["s"], blocks[st["i"]])

    out["short_ms"] = cuda_ms(step, 5 * reps)
    out["short_rt"] = 1000.0 * 2048 / plan.fs / out["short_ms"]
    print(f"flagship step_u8 block=2048: {out['short_ms']:.3f} ms/step, realtime "
          f"x{out['short_rt']:.2f} (a block is {1000.0 * 2048 / plan.fs:.3f} ms) {card}")

    d = WORK / "b4224"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    ini, iq = d / "flag.ini", d / "flag.u8"
    ini.write_text(flagship_ini(free_port()))
    cli("synth", "-s", ini, "--out", iq, "--seconds", 16 * 4224 / plan.fs, "--amplitude", 4,
        "--noise", 1.0)
    run = ("process-file", "-s", ini, "--iq", iq, "--block", 4224, "--device", DEVICE)
    with receivers_built() as built:
        summary = cli(*run, "--out", d / "k")
    (rx,) = built
    print(f"flagship --block 4224: {summary['blocks']} blocks, xtail {rx.xtail_len()}, "
          f"mix-cascade sites {sorted(rx.mix_cascades())}, dc_ingest launches "
          f"{rx.dc_ingest.launches} (expected {summary['blocks']})")
    if rx.block != 4224 or rx.dc_ingest.launches != summary["blocks"] or not summary["blocks"]:
        fail("flagship --block 4224: the DC kernel did not run once per block")
    cli(*run, "--out", d / "p", "--plain")
    audio_diff(read_audio(d / "k"), read_audio(d / "p"), "flagship --block 4224 kernel vs plain")
    out["b4224_launches"] = rx.dc_ingest.launches

    # a global key: ahead of the ini's first section.  The plan's own block
    # is 57,600 (a multiple of 256); 72,000 (Fs/4) is a multiple of its
    # chain divisor of 6 and not of 256
    plan288 = build_plan(parse_ini_text("correct_dc_bias=1\n" + INI_288))
    r288 = CompiledReceiver(plan288, 72_000, device=dev)
    p288 = CompiledReceiver(plan288, 72_000, device=dev, use_kernels=False)
    raw288 = torch.tensor(rng.integers(100, 156, (4, 2 * r288.block), dtype=np.uint8), device=dev)
    r288.dc_ingest.launches = 0
    k288 = steps_audio(r288, raw288)
    print(f"288k with DC correction: block {r288.block} ({r288.block % 256} past a multiple "
          f"of 256), dc_ingest launches {r288.dc_ingest.launches} (expected 4)")
    if r288.block != 72_000 or r288.dc_ingest.launches != 4:
        fail("288k with DC correction: the DC kernel did not run at block 72,000")
    audio_diff(joined(k288), joined(steps_audio(p288, raw288)), "288k+DC kernel vs plain")
    out["r288_launches"] = r288.dc_ingest.launches
    return out


class LoopbackRtlTcp(threading.Thread):
    """An rtl_tcp server on localhost serving ``blocks`` (u8 arrays) to one
    client: greeting, the client's 5 startup commands, ``delay`` s for ZMQ
    subscribers to join, the blocks (one every ``interval`` s, or as fast
    as the socket takes them), then one byte every 0.5 s (never a whole
    block) until the client leaves.  ``commands`` holds every 5-byte
    command received, startup and later."""

    def __init__(self, blocks, interval: float | None, delay: float = 1.0):
        super().__init__(daemon=True)
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(1)
        self.port = self.sock.getsockname()[1]
        self.blocks, self.interval, self.delay = blocks, interval, delay
        self.commands: list[tuple[int, int]] = []
        self.started = threading.Event()
        self.error: str | None = None
        self.start()

    def _read_commands(self, conn) -> None:
        buf = b""
        while chunk := conn.recv(4096):
            buf += chunk
            while len(buf) >= 5:
                self.commands.append((buf[0], struct.unpack(">I", buf[1:5])[0]))
                buf = buf[5:]

    def run(self) -> None:
        self.sock.settimeout(60)
        try:
            conn, _ = self.sock.accept()
        except OSError as e:
            self.error = f"accept: {e}"
            return
        with conn:
            conn.sendall(b"RTL0" + struct.pack(">II", 5, 29))
            reader = threading.Thread(target=self._read_commands, args=(conn,), daemon=True)
            reader.start()
            deadline = time.monotonic() + 30
            while len(self.commands) < 5 and time.monotonic() < deadline:
                time.sleep(0.01)
            time.sleep(self.delay)
            self.started.set()
            try:
                t0 = time.perf_counter()
                for i, b in enumerate(self.blocks):
                    if self.interval:
                        time.sleep(max(0.0, t0 + i * self.interval - time.perf_counter()))
                    conn.sendall(b.tobytes())
                end = time.monotonic() + 120
                while time.monotonic() < end:
                    time.sleep(0.5)
                    conn.sendall(b"\x7f")
            except OSError:
                pass  # the client left
            reader.join(timeout=10)
        self.sock.close()


def udp_ask(port: int, req: dict, timeout: float = 5.0) -> dict:
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as sk:
        sk.settimeout(timeout)
        sk.sendto(json.dumps(req).encode(), ("127.0.0.1", port))
        return json.loads(sk.recv(65536))


def await_control(port: int, deadline_s: float = 120.0) -> dict:
    """The first ``stats`` reply of a control socket that may not be bound
    yet (``run`` binds it once its source is open): asks every 0.2 s."""
    end = time.monotonic() + deadline_s
    while True:
        try:
            return udp_ask(port, {"stats": True}, timeout=0.2)
        except OSError:
            if time.monotonic() > end:
                raise


class Subscriber:
    """ZMQ SUB on ``port`` for ``topics``, connected before ``run`` binds;
    collects frames on its own thread until :meth:`close`."""

    def __init__(self, port: int, topics):
        import zmq

        self.ctx = zmq.Context()
        self.sock = self.ctx.socket(zmq.SUB)
        self.sock.setsockopt(zmq.RECONNECT_IVL, 10)
        self.sock.connect(f"tcp://127.0.0.1:{port}")
        for t in topics:
            self.sock.setsockopt(zmq.SUBSCRIBE, t.encode())
        self.frames: list[list[bytes]] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._go, daemon=True)
        self._thread.start()

    def _go(self) -> None:
        while not self._stop.is_set():
            if self.sock.poll(50):
                self.frames.append(self.sock.recv_multipart())

    def close(self) -> list[list[bytes]]:
        time.sleep(0.3)  # the last frames in flight
        self._stop.set()
        self._thread.join(timeout=5)
        self.sock.close(linger=0)
        self.ctx.term()
        return self.frames


def run_live(argv, during=None) -> tuple[dict, object]:
    """``run`` through the CLI in this process (its JSON summary and the
    receiver it built), with ``during()`` on a thread of its own."""
    th = None
    if during is not None:
        th = threading.Thread(target=during, daemon=True)
        th.start()
    with receivers_built() as built:
        summary = cli("run", *argv)
    if th is not None:
        th.join(timeout=30)
    (rx,) = built
    return summary, rx


def phase_rtl_tcp(dev, card: str, reps: int) -> dict:
    """11. Live run from a loopback rtl_tcp server, flagship, block 384,000."""
    from sdrreceiver_tpu_torch.graph.compiler import CompiledReceiver

    d = WORK / "live"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    n = 16
    raw, tones = flagship_stream(n, LIVE_BLOCK, seed=11)
    watch = sorted(tones)[:3]
    zport, cport = free_port(), free_port(socket.SOCK_DGRAM)
    srv = LoopbackRtlTcp(list(raw), interval=LIVE_BLOCK / 1_536_000)
    ini = d / "rtl.ini"
    ini.write_text(flagship_ini(zport, f"127.0.0.1:{srv.port}"))
    sub = Subscriber(zport, watch)
    retune = {}

    def during():
        srv.started.wait(timeout=60)
        time.sleep(1.0)
        retune["reply"] = udp_ask(cport, {"set_center_freq": 1_545_700_000})

    summary, rx = run_live(["-s", ini, "--device", DEVICE, "--max-blocks", n,
                            "--control-port", cport], during)
    frames = sub.close()
    srv.join(timeout=15)
    sites = rx.mix_cascades()
    launches = path_launches(rx)
    print(f"live rtl_tcp paced at 1.536 Msps: {summary['blocks']} blocks of {rx.block}, "
          f"ring {summary['ring']}, rtl_tcp {summary['rtl_tcp']}; launches {launches} "
          f"(expected {n} each)")
    startup = srv.commands[:5]
    want = [(0x08, 0), (0x03, 1), (0x0D, 0), (0x02, 1_536_000), (0x01, 1_545_600_000)]
    print(f"startup commands {startup} (expected {want}); later {srv.commands[5:]}; "
          f"UDP retune reply {retune.get('reply')}")
    if startup != want:
        fail("rtl_tcp startup commands")
    if summary["blocks"] != n or summary["ring"]["dropped"] or summary["rtl_tcp"]["reconnects"]:
        fail("live rtl_tcp: blocks dropped or reconnects")
    if rx.block != LIVE_BLOCK or len(launches) != 5 or any(v != n for v in launches.values()):
        fail("live rtl_tcp: the main path did not launch each kernel once per block")
    if retune.get("reply") != {"ok": True, "center_freq": 1_545_700_000} \
            or (0x01, 1_545_700_000) not in srv.commands[5:]:
        fail("live rtl_tcp: the UDP retune did not reach the server as a 0x01 command")
    lat = summary["block_latency_ms"]
    print(f"live rtl_tcp block_latency_ms p50 {lat['p50']} p95 {lat['p95']} max {lat['max']}, "
          f"{summary['msamples_per_second']} Msamples/s (paced) {card}")

    direct = CompiledReceiver(rx.plan, LIVE_BLOCK, device=dev)
    ref = steps_audio(direct, torch.tensor(raw, device=dev))
    rates = direct.rates()
    got: dict[str, list[np.ndarray]] = {t: [] for t in watch}
    for f in frames:
        topic = f[0].decode()
        if len(f) != 3 or len(f[0]) != 5 or topic not in got \
                or struct.unpack("<I", f[1])[0] != rates[f"audio/{topic}"]:
            fail(f"live rtl_tcp: malformed frame {[len(x) for x in f]} {f[:2]}")
        got[topic].append(np.frombuffer(f[2], np.int16))
    for topic, parts in got.items():
        k = len(parts)
        want_parts = [o[f"audio/{topic}"] for o in ref[n - k:]]
        same = k >= n - 1 and all(np.array_equal(a, b) for a, b in zip(parts, want_parts))
        print(f"live rtl_tcp ZMQ {topic}: {k} frames (of {n}; a late subscriber may miss the "
              f"first), bit-equal to step_u8 on the same bytes: {same}")
        if not same:
            fail(f"live rtl_tcp: {topic} frames differ from direct step_u8")
        a = np.concatenate(parts[-4:])
        check_tone(a, rates[f"audio/{topic}"], tones[topic], f"live rtl_tcp {topic}")

    n_fast = 20  # the ring's slots: none can drop however slow the consumer
    raw20, _ = flagship_stream(n_fast, LIVE_BLOCK, seed=12)
    srv = LoopbackRtlTcp(list(raw20), interval=None, delay=0.0)
    ini.write_text(flagship_ini(free_port(), f"127.0.0.1:{srv.port}"))
    fast, frx = run_live(["-s", ini, "--device", DEVICE, "--max-blocks", n_fast])
    srv.join(timeout=15)
    rt = fast["msamples_per_second"] * 1e6 / frx.plan.fs
    print(f"live rtl_tcp unpaced, {fast['blocks']} blocks of {frx.block}: "
          f"{fast['msamples_per_second']} Msamples/s, realtime x{rt:.2f}, block_latency_ms "
          f"p50 {fast['block_latency_ms']['p50']}, ring {fast['ring']} {card}")
    if fast["blocks"] != n_fast or fast["ring"]["dropped"] \
            or any(v != n_fast for v in path_launches(frx).values()):
        fail("live rtl_tcp unpaced: blocks dropped or kernels not launched")

    # the kernels at the live path's shapes, against their plain versions
    rng = np.random.default_rng(11)
    err, dc_ms, dc_plain_ms = kernel_vs_plain_dc(dev, LIVE_BLOCK, "u8", rng, reps, card)
    mc_err = mc_ms = mc_plain_ms = 0.0
    for name, (mc, t_len) in sites.items():
        xr = torch.tensor(rng.uniform(-128, 128, (1, t_len)).astype(np.float32), device=dev)
        xi = torch.tensor(rng.uniform(-128, 128, (1, t_len)).astype(np.float32), device=dev)
        ph = torch.tensor(rng.integers(0, mc.fs, mc.channels), device=dev)
        yr_k, yi_k = mc(ph, xr, xi)
        yr_p, yi_p = mc.plain(ph, xr, xi)
        e = max((yr_k - yr_p).abs().max().item(), (yi_k - yi_p).abs().max().item())
        p, k = in_turns(lambda: mc.plain(ph, xr, xi), lambda: mc(ph, xr, xi), reps)
        print(f"live-path mix_cascade {name}: T={t_len} max_abs_err={e:.3e} (limit 2e-3); "
              f"kernel {k:.4f} ms, plain {p:.4f} ms {card}")
        if not e <= 2e-3:
            fail(f"mix_cascade {name} at the live block disagrees with its plain version")
        mc_err, mc_ms, mc_plain_ms = max(mc_err, e), mc_ms + k, mc_plain_ms + p
    return {"launches": launches, "dc_err": err, "dc_ms": dc_ms, "dc_plain_ms": dc_plain_ms,
            "mc_err": mc_err, "mc_ms": mc_ms, "mc_plain_ms": mc_plain_ms, "sites": sorted(sites)}


def phase_scope(dev, card: str, reps: int) -> None:
    """12. run --iq --scope main --control-port, paced to realtime."""
    from sdrreceiver_tpu_torch.graph.compiler import CompiledReceiver

    d = WORK / "scope"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    n = 16  # 4 s of signal at realtime
    raw, _ = flagship_stream(n, LIVE_BLOCK, seed=13)
    (d / "rec.u8").write_bytes(raw.tobytes())
    ini = d / "flag.ini"
    ini.write_text(flagship_ini(free_port()))
    cport = free_port(socket.SOCK_DGRAM)
    replies = {}

    def during():
        replies["stats"] = await_control(cport)
        time.sleep(0.5)
        replies["set_scope"] = udp_ask(cport, {"set_scope": "CH000"})
        time.sleep(1.4)  # past the next frame the scope consumes
        replies["fft0"] = udp_ask(cport, {"set_fft": 0})
        replies["fft1"] = udp_ask(cport, {"set_fft": 1})
        replies["spectrum"] = udp_ask(cport, {"spectrum": 512})
        replies["bad"] = udp_ask(cport, {"set_scope": "NOPE"})

    summary, rx = run_live(["-s", ini, "--iq", d / "rec.u8", "--device", DEVICE,
                            "--block", LIVE_BLOCK, "--max-blocks", n, "--scope", "main",
                            "--control-port", cport], during)
    slack = summary.get("pacing_slack_ms", {})
    print(f"run --iq --scope main, paced: {summary['blocks']} blocks, pacing_slack_ms {slack}, "
          f"block_latency_ms {summary['block_latency_ms']} {card}")
    if summary["blocks"] != n or slack.get("behind_blocks") != 0:
        fail("run --iq --scope: fell behind realtime")
    spec = replies.get("spectrum", {})
    curve = np.asarray(spec.get("db", []), dtype=np.float64)
    print(f"control: stats {replies.get('stats')}, set_scope {replies.get('set_scope')}, "
          f"set_fft {replies.get('fft0')} / {replies.get('fft1')}, spectrum scope "
          f"{spec.get('scope')} bins {spec.get('bins')} max {curve.max() if curve.size else None} dB")
    bad = replies.get("bad", {})
    print(f"unknown tap reply: error {bad.get('error')!r}, {len(bad.get('valid', []))} valid taps")
    if replies.get("stats") != {"ok": True} \
            or replies.get("set_scope") != {"ok": True, "scope": "CH000", "rate": rx.tap_rates()["CH000"]} \
            or replies.get("fft0") != {"ok": True, "fft": 0} \
            or replies.get("fft1") != {"ok": True, "fft": 1} \
            or spec.get("bins") != 512 or curve.size != 512 or not np.isfinite(curve).all() \
            or not curve.max() > 0 or sorted(bad.get("valid", [])) != sorted(rx.tap_rates()):
        fail("run --scope: the control socket's replies")

    bare = CompiledReceiver(rx.plan, LIVE_BLOCK, device=dev)
    blocks = torch.tensor(raw, device=dev)
    st = {"t": rx.init_state(), "n": bare.init_state(), "i": 0}

    def step(r, key):
        def go():
            st["i"] = (st["i"] + 1) % n
            st[key], _ = r.step_u8(st[key], blocks[st["i"]])
        return go

    no_taps, taps = in_turns(step(bare, "n"), step(rx, "t"), reps)
    print(f"flagship step_u8 block={LIVE_BLOCK}: {len(rx.emit_taps)} scope taps compiled in "
          f"{taps:.3f} ms, none {no_taps:.3f} ms (in turns) {card}")


def phase_usb(card: str) -> None:
    """13. Local USB through the librtlsdr stub."""
    src = REPO / "tests" / "fake_librtlsdr.cpp"
    if not src.exists():
        fail(f"{src} is missing: the local USB path cannot be driven")
    so = REPO / "build" / "libfakertlsdr.so"
    so.parent.mkdir(exist_ok=True)
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-std=c++17", str(src), "-o", str(so)],
                   check=True, capture_output=True)
    os.environ["SDRX_LIBRTLSDR"] = str(so)
    from sdrreceiver_tpu_torch.cli.main import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["devices"])
    devs = [json.loads(line) for line in buf.getvalue().splitlines() if line.strip()]
    print(f"devices (stub): {[(x['index'], x['serial']) for x in devs]}")
    if rc != 0 or [x["serial"] for x in devs] != ["00000001", "77777777"]:
        fail("devices: the stub's two devices not listed")
    d = WORK / "usb"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    zport = free_port()
    ini = d / "usb.ini"
    # tests/test_rtlusb.py's USB_INI: a channel 1 kHz below the stub's +fs/8 tone
    ini.write_text(
        "sample_rate=1536000\ncenter_frequency=1545600000\n"
        f"zmq_address=tcp://127.0.0.1:{zport}\nauto_start_tuner_serial=77777777\n"
        "auto_start_biast=1\ntuner_gain=240\n[main_vfos]\nsize=1\n1\\frequency=1545791000\n"
        "1\\out_rate=384000\n[vfos]\nsize=1\n1\\frequency=1545791000\n1\\gain=0.2\n"
        "1\\data_rate=600\n1\\topic=VFO01\n")
    sub = Subscriber(zport, ["VFO01"])
    summary, rx = run_live(["-s", ini, "--device", DEVICE, "--block", 49152,
                            "--max-blocks", 40])
    frames = sub.close()
    launches = path_launches(rx)
    print(f"run on the USB stub: {summary['blocks']} blocks, ring {summary['ring']}, "
          f"restarts {summary['usb_restarts']}, launches {launches} (expected 40 each), "
          f"{len(frames)} ZMQ frames {card}")
    if summary["blocks"] != 40 or not launches or any(v != 40 for v in launches.values()) \
            or len(frames) < 5:
        fail("run on the USB stub: blocks, launches or frames missing")
    pcm = np.concatenate([np.frombuffer(f[2], np.int16) for f in frames[-5:]]).astype(np.float64)
    spec = np.abs(np.fft.rfft(pcm * np.hanning(len(pcm))))
    peak = np.argmax(spec) * 12000 / len(pcm)
    lib = ctypes.CDLL(str(so))
    for f in ("fake_get_bias_tee", "fake_get_gain", "fake_get_open"):
        getattr(lib, f).restype = ctypes.c_int
        getattr(lib, f).argtypes = [ctypes.c_int]
    state = (lib.fake_get_bias_tee(1), lib.fake_get_gain(1), lib.fake_get_open(1))
    print(f"USB stub audio peak {peak:.1f} Hz (expected 1000 +-30); device 1 bias tee, gain, "
          f"open = {state} (expected (1, 240, 0))")
    if abs(peak - 1000.0) > 30 or state != (1, 240, 0):
        fail("run on the USB stub: tone, bias tee or close")


def phase_bench(card: str) -> dict:
    """14. bench on the flagship, kernel path and --plain in turns."""
    d = WORK / "bench"
    d.mkdir(parents=True, exist_ok=True)
    ini = d / "flag.ini"
    ini.write_text(flagship_ini(free_port()))
    out = {}
    for block in (LIVE_BLOCK, 1_536_000):
        runs = {"plain": [], "kernels": []}
        for mode in ("plain", "kernels", "kernels", "plain"):
            extra = ("--plain",) if mode == "plain" else ()
            r = cli("bench", "-s", ini, "--device", DEVICE, "--block", block, "--blocks", 20, *extra)
            if r["mode"] != mode or r["block_samples"] != block:
                fail(f"bench: {r['mode']} at {r['block_samples']}")
            runs[mode].append(r)
        for mode, rs in runs.items():
            print(f"bench flagship block={block} {mode}: "
                  f"{[r['msamples_per_second'] for r in rs]} Msamples/s, realtime "
                  f"{[r['realtime_factor'] for r in rs]} (device {rs[0]['device']}) {card}")
        out[block] = runs
    return out


def phase_device_time(card: str) -> dict[str, dict]:
    """3 (end). Device time of each kernel per call (torch.profiler), its
    bound and share of the bound, at the flagship, live, alt-rate and ragged
    shapes; fails unless every call ran one kernel of its own (and, for
    dc_ingest, one memset)."""
    from sdrreceiver_tpu_torch.cuda import devtime

    out = {}
    for c in devtime.measure(calls=50, step=False):
        rows = c["rows_per_call"]
        own = sum(n for k, n in rows.items() if ("dc_" if c["kernel"] == "dc_ingest"
                                                   else "mix_cascade") in k)
        print(f"device time {c['kernel']} {c['case']}: {c['device_us']:.2f} us per call "
              f"({own:g} kernel, {sum(rows.values()):g} device ops), bound {c['bound_us']:.2f} us "
              f"({c['bound_by']}), share of bound {c['bound_us'] / c['device_us']:.3f} {card}")
        if own != 1 or sum(rows.values()) > 2:
            fail(f"{c['kernel']} {c['case']}: {rows} device ops per call")
        out[f"{c['kernel']} {c['case']}"] = c
    return out


def timing_keys(devt: dict, keys: list[str]) -> dict:
    """The kernels-line keys that come from the device-time cases ``keys``
    (summed; the bound of several mix-cascade calls from their summed bytes
    and operations)."""
    from sdrreceiver_tpu_torch.cuda import devtime

    cases = [devt[k] for k in keys]
    if len(cases) == 1:
        bound, by = cases[0]["bound_us"], cases[0]["bound_by"]
    else:
        bound, by = devtime.joint_bound(cases)
    us = sum(c["device_us"] for c in cases)
    # no single PyTorch call computes either function (a recursive one-pole
    # filter; an NCO mix followed by a strided composite FIR)
    return {"device_us": us, "bound_us": bound, "bound_ms": bound / 1e3, "bound_by": by,
            "library_ms": None}


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
        m_k2, (yr_k2, yi_k2) = dck(mean, raw)
        if not (torch.equal(m_k, m_k2) and torch.equal(yr_k, yr_k2) and torch.equal(yi_k, yi_k2)):
            fail(f"dc_ingest {name}: two calls on the same input differ")

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
    devt = phase_device_time(card)

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

    # ---- 10-14. block sizes and the live entry ----
    blk = phase_blocks(dev, card, reps)
    live = phase_rtl_tcp(dev, card, reps)
    phase_scope(dev, card, reps)
    phase_usb(card)
    phase_bench(card)
    live_mc = sum(n for k, n in live["launches"].items() if k.startswith("mix_cascade"))

    kernels = [
        {"name": "dc_ingest", "route": "cuda",
         "source": "sdrreceiver_tpu_torch/csrc/dc_ingest.cu",
         "replaces": "sdrreceiver_tpu/pallas/dckernel.py:176",
         "launches": dc_launches, "max_abs_err": dc_err,
         "ms": dc_ms, "plain_ms": dc_plain_ms,
         **timing_keys(devt, ["dc_ingest u8 T=1536000"])},
        {"name": "mix_cascade", "route": "cuda",
         "source": "sdrreceiver_tpu_torch/csrc/mix_cascade.cu",
         "replaces": "sdrreceiver_tpu/pallas/frontend.py:488",
         "also_replaces": "sdrreceiver_tpu/pallas/frontend.py:672",
         "launches": sum(mc_launches), "max_abs_err": mc_err,
         "ms": mc_ms, "plain_ms": mc_plain_ms,
         **timing_keys(devt, [f"mix_cascade flagship block {BLOCK} {k}" for k in sites])},
        {"name": "dc_ingest (alt-rate f32 entry, T=480000)", "route": "cuda",
         "source": "sdrreceiver_tpu_torch/csrc/dc_ingest.cu",
         "replaces": "sdrreceiver_tpu/pallas/dckernel.py:176",
         "launches": alt["rx_launches"]["dc_ingest"], "max_abs_err": at["dc_err"],
         "ms": at["dc_ms"], "plain_ms": at["dc_plain_ms"],
         **timing_keys(devt, [f"dc_ingest f32 T={ALT_BLOCK}"])},
        {"name": "mix_cascade (alt-rate: front C=2 d=[3,3], g0/b0 C=3 d=2)", "route": "cuda",
         "source": "sdrreceiver_tpu_torch/csrc/mix_cascade.cu",
         "replaces": "sdrreceiver_tpu/pallas/frontend.py:488",
         "also_replaces": "sdrreceiver_tpu/pallas/frontend.py:672",
         "launches": alt_mc, "max_abs_err": at["mc_err"],
         "ms": at["mc_ms"], "plain_ms": at["mc_plain_ms"],
         **timing_keys(devt, [f"mix_cascade altrate block {ALT_BLOCK} {k}"
                              for k in alt["sites"]])},
        {"name": "dc_ingest (partial last tile, u8 T=4224: flagship --block 4224)",
         "route": "cuda", "source": "sdrreceiver_tpu_torch/csrc/dc_ingest.cu",
         "replaces": "sdrreceiver_tpu/pallas/dckernel.py:176",
         "launches": blk["b4224_launches"], "max_abs_err": blk["err"],
         "ms": blk[(4224, "u8")][0], "plain_ms": blk[(4224, "u8")][1],
         **timing_keys(devt, ["dc_ingest u8 T=4224"])},
        {"name": "dc_ingest (partial last tile, u8 T=72000: 288k plan with DC)",
         "route": "cuda", "source": "sdrreceiver_tpu_torch/csrc/dc_ingest.cu",
         "replaces": "sdrreceiver_tpu/pallas/dckernel.py:176",
         "launches": blk["r288_launches"], "max_abs_err": blk["err"],
         "ms": blk[(72_000, "u8")][0], "plain_ms": blk[(72_000, "u8")][1],
         **timing_keys(devt, ["dc_ingest u8 T=72000"])},
        {"name": "dc_ingest (live run over rtl_tcp, u8 T=384000)", "route": "cuda",
         "source": "sdrreceiver_tpu_torch/csrc/dc_ingest.cu",
         "replaces": "sdrreceiver_tpu/pallas/dckernel.py:176",
         "launches": live["launches"]["dc_ingest"], "max_abs_err": live["dc_err"],
         "ms": live["dc_ms"], "plain_ms": live["dc_plain_ms"],
         **timing_keys(devt, [f"dc_ingest u8 T={LIVE_BLOCK}"])},
        {"name": "mix_cascade (live run over rtl_tcp, block 384000, 4 sites)", "route": "cuda",
         "source": "sdrreceiver_tpu_torch/csrc/mix_cascade.cu",
         "replaces": "sdrreceiver_tpu/pallas/frontend.py:488",
         "also_replaces": "sdrreceiver_tpu/pallas/frontend.py:672",
         "launches": live_mc, "max_abs_err": live["mc_err"],
         "ms": live["mc_ms"], "plain_ms": live["mc_plain_ms"],
         **timing_keys(devt, [f"mix_cascade flagship block {LIVE_BLOCK} {k}"
                              for k in live["sites"]])},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
