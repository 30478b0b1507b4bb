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
 15. the sharded receiver (``dist/``): the flagship on 4x1, 2x2 and 1x4
     meshes of four shards of one card (and of four cards where there
     are), at blocks 1,536,000 and 384,000, and the IQ plan on 2x2, 3 blocks
     each against one device (audio, IQ bytes, taps, exported state); the
     per-shard mix-cascade launches; each per-shard site of every mesh
     against its plain version; the sharded step beside the one-device step
 16. the 66-channel, 3-group plan (tests/test_dist.py, BASELINE config 5)
     at its block of 384,000 on a 2x4 mesh against one device
 17. ``process-file --mesh 2x1`` on the alt-rate recording against phase 6
 18. two ``process-file`` processes on the card joined on gloo: the
     groups partition (union bit-equal to one process, no topic twice),
     ``--partition global --mesh 2x1`` (each process writes its own topics,
     union within 1 LSB); each process's kernels launched once a block,
     through CUDA graphs (the summaries say ``"cuda_graphs": true``);
     three processes for two groups (one exits 1)
 19. the step entries as CUDA graphs (the receiver's default on the card;
     every phase above runs through them): the flagship ``step_u8`` at
     1,536,000, 384,000 and 2048, the alt-rate ``step_f32`` at 480,000, the
     IQ plan and the 288k plan, each against the eager step
     (``cuda_graphs=False``) on the same blocks, audio, ``iq/``, ``tap/``
     and exported state bit-equal; ``step_many_*`` with k=4 bit-equal to 4
     graph steps; the profiler's kernels and memsets per replayed step equal
     to the eager step's and to the wrappers' counts; step ms in turns,
     realtime factor, device time, idle share, CUDA rows and peak memory of
     both paths; the alt-rate runtime at ``--burst 1`` and 4
 20. the sharded receiver's step entries as CUDA graphs, one per phase and
     card (the default for a mesh in one process; phases 15-17 run through
     them): the flagship on 4x1, 2x2 and 1x4 at 1,536,000 and 384,000, the
     IQ plan on 2x2 and the 66-channel plan on 2x4, on four shards of one
     card (and on four cards where there are), each against the eager mesh
     step (``cuda_graphs=False``): outputs and exported state bit-equal,
     the same per-shard launches, ``step_many_u8`` k=4 bit-equal to 4 graph
     steps; on the flagship the profiler's ``mix_cascade`` rows per replay
     equal to the eager step's and the wrappers' counts, step ms in turns,
     device time, idle share and peak memory of both; then ``run --mesh
     2x1`` over loopback rtl_tcp (ZMQ audio bit-equal to the mesh
     receiver's ``step_u8``), ``bench --mesh 4x1``, and a capture that
     cannot hold its step fails it (``chip_smoke.py --capture-failure``, a
     process of its own, exits non-zero)
 21. the sharded receiver's step entries as CUDA graphs across processes:
     the flagship on a ``--partition global`` mesh 2x1 over two processes
     on the card (``chip_smoke.py --procgraphs``; gloo exchanges between
     the phases), and where there are two cards or more a global 2x1 with
     a card a process (and with four, a global 4x1 of two cards a
     process), whose exchanges are NCCL collectives inside the graphs, at
     1,536,000 and 384,000, graphs against the eager step in each process:
     outputs and exported state bit-equal (on distinct cards also to the
     same graphs with gloo exchanges), ``step_many_u8`` k=4 bit-equal to 4
     graph steps, each process's per-shard mix-cascade site against its
     plain version, the same ``mix_cascade`` launches and profiler rows
     per replay as per eager step, step ms in turns, graphs, transfers,
     host exchanges and NCCL rows per replay, device µs, idle share and
     peak memory; then the first card runs of ``bench --coordinator``
     under both partitions (eff(2), ``sps_1_full_plan``; ``"exchange":
     "gloo"`` on one card) and of ``run --coordinator --partition global
     --mesh 2x1`` over loopback rtl_tcp (no drop, each process's ZMQ audio
     bit-equal to its own topics of the one-process 2x1 mesh's
     ``step_u8``), and a capture that fails in one process of two
     (``chip_smoke.py --capture-failure-procs``): both processes exit
     non-zero, the peer on its next exchange.  Then the flagship on a
     global 1x2 over the two processes on the card at 384,000 (a time row
     across both: each process computes the whole front and only its own
     channel ranges of the split buckets, the other ranges come through
     one gloo ``"chan"`` exchange a bucket): graphs bit-equal to eager, the
     union of the topics each process publishes bit-equal to the
     one-process 1x2 mesh, the per-shard ``mix_cascade`` site in each
     process against its plain version (the kernels line's global 1x2 row);
     and the flagship on a global 2x3 over three processes each holding
     the card twice (each process's devices end one time row or begin the
     next; process 1 computes both time shards), checked the same way
     against the one-process 2x3 (the kernels line's global 2x3 row)

``chip_smoke.py --tracer`` runs only the in-program tracer's check on one
card (``tracer_hold``): a callback that holds the host 1 ms a block, read
on the device timeline of the tracer's CUDA events.

``chip_smoke.py --four-cards`` runs only phase 20's four-card meshes and
phase 21's paths on distinct cards (a machine of four cards);
``chip_smoke.py --procs-on-cards`` only the latter (two cards or more), a
card a process and NCCL inside the graphs: the global 2x1; the global 1x2
of the flagship at 1,536,000 and 384,000 and of the 66-channel plan at
384,000 (each checked as above, and also against the same graphs with
gloo exchanges, with 0 host exchanges a replay, its NCCL rows, device µs,
idle share and peak memory), step ms of the global 1x2 / global 2x1 /
one-process 1x2 over the same cards / one device; with four cards, the
global 4x1 of two cards a process and the flagship's global 2x2 of four
processes (rows and columns both across processes); ``bench
--coordinator --partition global --mesh 1x2`` and ``run`` over rtl_tcp on
the global 1x2 (NCCL, ZMQ audio bit-equal to the one-process 1x2 over
the same cards); the capture failure on distinct cards; and with three
cards or more, each process one card held several times: the flagship's
global 2x3 of three processes at 1,536,000 and 384,000, cband66's at
384,000 and the flagship's global 3x2 of two processes at 384,000 (each
checked as above), ``process-file --mesh 2x3 --partition global
--num-processes 3`` (``proc_cli_layout``), and a peer of the 2x3 that
leaves after two replays, which must end the other two with exit code 1
within ``TIMEOUT_S + END_GRACE_S`` (``chip_smoke.py --peer-dies``).

Phases 15-17 hold every per-shard mix-cascade site of every sharded
receiver they build against its plain version; phase 18's processes run
the CLI through ``chip_smoke.py --cli ARGS``, which reports their launch
counts.  The line before the last is a JSON summary of the kernels; the last
line is ``{"ok": true, "device": {...}}``.
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
    plain = CompiledReceiver(plan, IQ_BLOCK, emit_taps=taps, device=dev, use_kernels=False,
                             cuda_graphs=False)
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
    """Launch counts of every kernel wrapper on ``rx``'s path (under a mesh
    the DC runs through the halo composition, not the DC kernel)."""
    out = {"dc_ingest": rx.dc_ingest.launches} if rx.plan.dc_correct and rx.mesh is None else {}
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
    short_plain = CompiledReceiver(plan, 2048, device=dev, use_kernels=False, cuda_graphs=False)
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
    p288 = CompiledReceiver(plan288, 72_000, device=dev, use_kernels=False, cuda_graphs=False)
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
    lat = summary["host_ms_per_block"]
    print(f"live rtl_tcp host_ms_per_block p50 {lat['p50']} p95 {lat['p95']} max {lat['max']}, "
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
          f"{fast['msamples_per_second']} Msamples/s, realtime x{rt:.2f}, host_ms_per_block "
          f"p50 {fast['host_ms_per_block']['p50']}, ring {fast['ring']} {card}")
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
          f"host_ms_per_block {summary['host_ms_per_block']} {card}")
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
    rx_plain = CompiledReceiver(plan, ALT_BLOCK, device=dev, use_kernels=False, cuda_graphs=False)
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


def cband_ini(n_subs: int = 66) -> str:
    """tests/test_dist.py's ``_cband_scale_ini`` (BASELINE config 5): a
    CBAND-style wideband plan, 3 main groups, ``n_subs`` sub-VFOs."""
    centers = (1545116000, 1546096000, 1546796000)
    rates = (384000, 192000, 192000)
    lines = ["sample_rate=1536000", "center_frequency=1545900000",
             "zmq_address=tcp://*:6003", "correct_dc_bias=1", "[main_vfos]",
             f"size={len(centers)}"]
    for i, (f, r) in enumerate(zip(centers, rates), 1):
        lines += [f"{i}\\frequency={f}", f"{i}\\out_rate={r}"]
    lines += ["[vfos]", f"size={n_subs}"]
    for i in range(1, n_subs + 1):
        g = (i - 1) % 3
        lines += [f"{i}\\frequency={centers[g] - rates[g] // 3 + (i // 3) * 9000}",
                  f"{i}\\gain=5", f"{i}\\data_rate={(600, 1200, 10500)[g]}",
                  f"{i}\\topic=CH{i:03d}"]
        if i % 5 == 0:
            lines.append(f"{i}\\filter_bandwidth=4000")
    return "\n".join(lines)


def plan_stream(plan, n_blocks: int, block: int, seed: int) -> np.ndarray:
    """u8 ``[n_blocks, 2*block]``: tones at amplitude 4 in every third
    topic, noise 1.0, as ``flagship_stream`` for any plan."""
    from sdrreceiver_tpu_torch.io.iqfile import synthesize_channels, to_u8

    subs = sorted((s for g in plan.groups for b in g.buckets for s in b.subs),
                  key=lambda s: s.config_index)
    iq = synthesize_channels(
        n_blocks * block, plan.fs, plan.center_frequency,
        [(s.frequency, 500 + 37 * i, 4.0) for i, s in enumerate(subs) if i % 3 == 0],
        noise=1.0, seed=seed,
    )
    return to_u8(iq).reshape(n_blocks, 2 * block)


def run_steps(rx, blocks) -> tuple[list[dict], dict]:
    """(per-block outputs on the host after ``split_audio``, the exported
    final state) of ``rx`` stepped over u8 ``blocks``."""
    st, out = rx.init_state(), []
    for b in blocks:
        st, o = rx.step_u8(st, b)
        out.append({k: v.cpu().numpy() for k, v in rx.split_audio(o).items()})
    return out, rx.export_state(st)


def outputs_diff(ours: list[dict], ref: list[dict], what: str) -> dict:
    """Every output of a run against a reference run: audio as
    ``audio_diff``; ``iq/`` bytes under 1e-3 differing by at most one nibble
    step; taps within 1e-4 of their peak.  Fails the script otherwise."""
    def pick(outs, pre):
        return {f"{i}/{k}": v for i, o in enumerate(outs) for k, v in o.items() if k.startswith(pre)}

    lsb, flip = audio_diff(pick(ours, "audio/"), pick(ref, "audio/"), what)
    iq_o, iq_r = pick(ours, "iq/"), pick(ref, "iq/")
    share = 0.0
    for k, b in iq_r.items():
        a = iq_o[k]
        step = max(int(np.abs(x - y).max()) for x, y in zip(nibbles(a), nibbles(b)))
        share = max(share, float((a != b).mean()))
        if a.shape != b.shape or share >= 1e-3 or step > 1:
            fail(f"{what} {k}: {share:.2e} of bytes, {step} nibble steps")
    tap_o, tap_r = pick(ours, "tap/"), pick(ref, "tap/")
    tap = max((float(np.abs(tap_o[k] - b).max() / np.abs(b).max()) for k, b in tap_r.items()),
              default=0.0)
    if tap > 1e-4:
        fail(f"{what}: taps differ by {tap:.2e} of their peak")
    if iq_r or tap_r:
        print(f"{what}: iq/ worst {share:.2e} of bytes differ (limit 1e-3, one nibble step); "
              f"taps within {tap:.2e} of peak (limit 1e-4)")
    return {"lsb": lsb, "flip": flip}


def state_diff(ours: dict, ref: dict, what: str) -> float:
    """Exported states: the same leaves, NCO integers equal, floats within
    1e-3 (u8-scale DC means and tails)."""
    if set(ours) != set(ref):
        fail(f"{what}: state leaves differ")
    worst = 0.0
    for k, r in ref.items():
        if ours[k].shape != r.shape or ours[k].dtype != r.dtype:
            fail(f"{what}: state {k} {ours[k].dtype} {ours[k].shape} vs {r.dtype} {r.shape}")
        if r.dtype == np.uint32:
            if not np.array_equal(ours[k], r):
                fail(f"{what}: state {k} differs")
        else:
            worst = max(worst, float(np.abs(ours[k].astype(np.complex128) - r).max()))
    print(f"{what}: export_state max float diff {worst:.2e} (limit 1e-3), integers equal")
    if worst > 1e-3:
        fail(f"{what}: state differs")
    return worst


def sites_vs_plain(rx, what: str, card: str = "", reps: int = 0) -> dict:
    """Each mix-cascade site of ``rx`` against its plain version on the
    same card inputs (uniform +-128 at the site's shape, on the site's
    device); fails above 2e-3 (expected 0: kernel and plain version agree
    bit for bit).  With ``reps``, the kernel's and the plain version's
    times in turns too, summed over the sites.  Call it after the main
    path's launch counts are read: these launches are not the path's."""
    out = {"err": 0.0, "ms": 0.0, "plain_ms": 0.0}
    rng = np.random.default_rng(16)
    for site, (mc, t_len) in rx.mix_cascades().items():
        d = mc.taps.device
        xr = torch.tensor(rng.uniform(-128, 128, (1, t_len)).astype(np.float32), device=d)
        xi = torch.tensor(rng.uniform(-128, 128, (1, t_len)).astype(np.float32), device=d)
        ph = torch.tensor(rng.integers(0, mc.fs, mc.channels), device=d)
        (yr_k, yi_k), (yr_p, yi_p) = mc(ph, xr, xi), mc.plain(ph, xr, xi)
        err = max((yr_k - yr_p).abs().max().item(), (yi_k - yi_p).abs().max().item())
        out["err"] = max(out["err"], err)
        timing = ""
        if reps:
            p_ms, k_ms = in_turns(lambda: mc.plain(ph, xr, xi), lambda: mc(ph, xr, xi), reps)
            out["ms"] += k_ms
            out["plain_ms"] += p_ms
            timing = f"; kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms {card}"
        print(f"kernel mix_cascade {site} ({what}): C={mc.channels} depths={mc.depths} "
              f"T={t_len} on {d} max_abs_err={err:.3e} (limit 2e-3, expected 0){timing}")
        if not err <= 2e-3:
            fail(f"{what}: mix_cascade {site} disagrees with its plain version")
    return out


def phase_mesh(dev, card: str, reps: int) -> dict:
    """15. The sharded receiver: the flagship on 4x1, 2x2 and 1x4 meshes
    (four shards of one card, and four cards where there are) at blocks
    1,536,000 and 384,000, and the IQ plan on 2x2, against one device."""
    from sdrreceiver_tpu_torch.dist import ShardedReceiver, make_mesh
    from sdrreceiver_tpu_torch.flagship import benchmark_config
    from sdrreceiver_tpu_torch.graph.compiler import CompiledReceiver
    from sdrreceiver_tpu_torch.graph.config import parse_ini_text
    from sdrreceiver_tpu_torch.graph.plan import build_plan

    layouts = [("one card x4", [dev] * 4)]
    if torch.cuda.device_count() >= 4:
        layouts.append(("four cards", [torch.device("cuda", i) for i in range(4)]))
    out = {"err": 0.0, "launches": 0, "ms": 0.0, "plain_ms": 0.0}
    cases = [(build_plan(benchmark_config()), block, "flagship", ()) for block in (BLOCK, LIVE_BLOCK)]
    cases.append((build_plan(parse_ini_text(IQ_INI)), IQ_BLOCK, "iq plan", ("main", "g0", "VFO01")))
    for plan, block, name, taps in cases:
        blocks = torch.tensor(plan_stream(plan, 3, block, seed=15), device=dev)
        single = CompiledReceiver(plan, block, emit_taps=taps, device=dev)
        ref, ref_state = run_steps(single, blocks)
        shapes = ((2, 2),) if taps else ((4, 1), (2, 2), (1, 4))
        for lname, devs in layouts:
            for shape in shapes:
                rx = ShardedReceiver(plan, make_mesh(*shape, devs), block, emit_taps=taps)
                sites = rx.mix_cascades()
                for mc, _ in sites.values():
                    mc.launches = 0
                got, state = run_steps(rx, blocks)
                for d in set(devs):
                    torch.cuda.synchronize(d)
                launches = {k: mc.launches for k, (mc, _) in sites.items()}
                what = f"{name} block {block} mesh {shape[0]}x{shape[1]} ({lname})"
                print(f"{what}: per-shard mix_cascade launches over 3 steps {launches} "
                      f"(expected {shape[0]} sites x 3, the merged front), chan ranges "
                      f"{ {k: [(lo, hi) for lo, hi, _, _ in v] for k, v in rx._chan_parts.items()} }")
                if len(sites) != shape[0] or any(n != 3 for n in launches.values()):
                    fail(f"{what}: the per-shard kernels did not run once a step")
                outputs_diff(got, ref, f"{what} vs one device")
                state_diff(state, ref_state, what)
                timed = lname == layouts[0][0] and shape == (4, 1) and block == BLOCK
                vs = sites_vs_plain(rx, what, card, reps if timed else 0)
                out["err"] = max(out["err"], vs["err"])
                if timed:
                    out.update(launches=sum(launches.values()), sites=sorted(sites),
                               shard_t=sites["shard0/front"][1], ms=vs["ms"],
                               plain_ms=vs["plain_ms"])
                if name == "flagship":
                    st = {"s": rx.init_state(), "t": single.init_state(), "i": 0}

                    def step(r, key):
                        def go():
                            st["i"] = (st["i"] + 1) % 3
                            st[key], _ = r.step_u8(st[key], blocks[st["i"]])
                        return go

                    one_ms, mesh_ms = in_turns(step(single, "t"), step(rx, "s"), reps)
                    out[(block, lname, shape)] = (mesh_ms, one_ms)
                    print(f"time {what}: sharded step_u8 {mesh_ms:.3f} ms, one device "
                          f"{one_ms:.3f} ms (x{mesh_ms / one_ms:.2f}) {card}")
    return out


def phase_cband(dev, card: str) -> float:
    """16. The 66-channel, 3-group plan at its own block of 384,000 on a
    2x4 mesh, against one device; its per-shard sites against their plain
    version (the worst error)."""
    from sdrreceiver_tpu_torch.dist import ShardedReceiver, local_devices, make_mesh
    from sdrreceiver_tpu_torch.graph.compiler import CompiledReceiver
    from sdrreceiver_tpu_torch.graph.config import parse_ini_text
    from sdrreceiver_tpu_torch.graph.plan import build_plan

    plan = build_plan(parse_ini_text(cband_ini(66)))
    block = plan.block_samples
    blocks = torch.tensor(plan_stream(plan, 3, block, seed=16), device=dev)
    ref, ref_state = run_steps(CompiledReceiver(plan, block, device=dev), blocks)
    devs = local_devices(8, DEVICE)
    rx = ShardedReceiver(plan, make_mesh(2, 4, devs), block)
    sites = rx.mix_cascades()
    for mc, _ in sites.values():
        mc.launches = 0
    t0 = time.perf_counter()
    got, state = run_steps(rx, blocks)
    secs = time.perf_counter() - t0
    launches = {k: mc.launches for k, (mc, _) in sites.items()}
    what = (f"cband {plan.num_channels()} channels, {len(plan.groups)} groups, block {block}, "
            f"mesh 2x4 over {sorted({str(d) for d in devs})}")
    print(f"{what}: launches {launches} (expected 2 sites x 3); {len(rx._chan_parts)} buckets "
          f"split over 4 channel ranges; 3 steps in {secs:.3f} s (with their host copies) {card}")
    if len(sites) != 2 or any(n != 3 for n in launches.values()) or plan.num_channels() != 66:
        fail("cband: the per-shard kernels did not run once a step")
    outputs_diff(got, ref, f"{what} vs one device")
    state_diff(state, ref_state, "cband 2x4")
    return sites_vs_plain(rx, "cband 2x4")["err"]


def phase_alt_mesh(alt: dict) -> dict:
    """17. ``process-file --mesh 2x1`` on the alt-rate recording."""
    d = WORK / "alt"
    with receivers_built() as built:
        summary = cli("process-file", "-s", d / "alt.ini", "--device", DEVICE, "--iq",
                      d / "alt.u8", "--out", d / "m", "--mesh", "2x1")
    (rx,) = built
    launches = {k: mc.launches for k, (mc, _) in rx.mix_cascades().items()}
    print(f"alt-rate process-file --mesh 2x1: block {rx.block}, {summary['blocks']} blocks, "
          f"launches {launches} (expected 2 sites x {summary['blocks']}), realtime factor "
          f"{summary['realtime_factor']}")
    if len(launches) != 2 or any(n != summary["blocks"] for n in launches.values()):
        fail("alt-rate --mesh 2x1: the per-shard kernels did not run once a block")
    audio_diff(read_audio(d / "m"), read_audio(d / "k"), "alt-rate --mesh 2x1 vs one device")
    return {"launches": launches, "summary": summary,
            "err": sites_vs_plain(rx, "alt-rate --mesh 2x1")["err"]}


def cli_child(argv: list[str]) -> int:
    """``chip_smoke.py --cli ARGS``: the port's CLI in this process, as
    phase 18 starts its processes; after the CLI's own output, a last line
    with the launch counts of every receiver the CLI built.  Under
    ``--coordinator`` the counts are read, and the receivers let go, when
    the CLI leaves its process group: a live receiver whose graphs
    captured NCCL collectives holds the group's teardown."""
    from sdrreceiver_tpu_torch.cli.main import main as cli_main
    from sdrreceiver_tpu_torch.dist import multihost

    launches: list[dict] = []
    leave = multihost.shutdown

    def read_then_leave():
        launches.extend(path_launches(rx) for rx in built)
        built.clear()
        leave()

    with receivers_built() as built:
        multihost.shutdown = read_then_leave
        try:
            rc = cli_main(argv)
        finally:
            multihost.shutdown = leave
        launches.extend(path_launches(rx) for rx in built)
    print(json.dumps({"launches": launches}))
    return rc


def processes(argvs: list[list], timeout: float = 300.0,
              envs: list[dict] | None = None) -> list[tuple[int, str, str]]:
    """Run ``chip_smoke.py ARGV`` (``--cli ARGS``: the port's CLI through
    :func:`cli_child`) in one process per argv, all at once, each with
    ``envs[i]`` added to its environment; (exit code, stdout, stderr) of
    each.  A process still running after ``timeout`` s is killed (exit
    code -9) and gives what it printed; 15 s before that it prints every
    thread's stack to its stderr (``SMOKE_DUMP_S``)."""
    envs = envs or [{}] * len(argvs)
    dump = {"SMOKE_DUMP_S": str(max(timeout - 15, 1))}
    procs = [subprocess.Popen([sys.executable, str(REPO / "chip_smoke.py"), *map(str, a)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=dict(os.environ, PYTHONPATH=str(REPO), **dump, **e),
                              cwd=str(REPO))
             for a, e in zip(argvs, envs)]
    deadline = time.monotonic() + timeout
    res = []
    try:
        for p in procs:
            try:
                res.append(p.communicate(timeout=max(deadline - time.monotonic(), 0.1)))
            except subprocess.TimeoutExpired:
                p.kill()
                res.append(p.communicate())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return [(p.returncode, so, se) for p, (so, se) in zip(procs, res)]


def phase_multihost(card: str) -> None:
    """18. Two ``process-file`` processes on the one card, joined on gloo:
    the groups partition, then ``--partition global --mesh 2x1``; then three
    processes for two groups."""
    d = WORK / "alt"
    single = read_audio(d / "k")

    def fleet(tag: str, n: int, *extra):
        coord = f"127.0.0.1:{free_port()}"
        t0 = time.perf_counter()
        res = processes([["--cli", "process-file", "-s", d / "alt.ini", "--iq", d / "alt.u8",
                          "--out", d / f"{tag}{i}", "--device", DEVICE, "--coordinator", coord,
                          "--num-processes", n, "--process-id", i, *extra] for i in range(n)])
        return res, time.perf_counter() - t0

    def ran(res, what: str) -> list[dict]:
        """Each process's JSON summary; fails unless it exited 0, stepped
        through CUDA graphs and every kernel wrapper on its path launched
        once a block."""
        out = []
        for rc, so, se in res:
            if rc:
                fail(f"{what}: a process exited {rc}: {se[-2000:]}")
            *_, summary, last = so.strip().splitlines()
            summary = json.loads(summary)
            (launches,) = json.loads(last)["launches"]
            print(f"{what}: process {summary['multihost']['process_id']} launches {launches} "
                  f"over {summary['blocks']} blocks, cuda_graphs {summary['cuda_graphs']}")
            if not launches or any(n != summary["blocks"] for n in launches.values()):
                fail(f"{what}: a process did not launch its kernels once a block")
            if not summary["cuda_graphs"]:
                fail(f"{what}: a process stepped eagerly")
            out.append(summary)
        return out

    res, secs = fleet("mg", 2)
    mh = [s["multihost"] for s in ran(res, "groups partition")]
    parts = [read_audio(d / f"mg{i}") for i in range(2)]
    same = all(np.array_equal(v, single[k]) for p in parts for k, v in p.items())
    print(f"groups partition, 2 processes on one card: groups {[m['local_groups'] for m in mh]}, "
          f"topics {[sorted(p) for p in parts]}; union bit-equal to one process: {same} "
          f"({secs:.1f} s for both, start-up included) {card}")
    if set(parts[0]) & set(parts[1]) or set(parts[0]) | set(parts[1]) != set(single) or not same:
        fail("groups partition: the union is not the single-process files")

    res, secs = fleet("mw", 2, "--partition", "global", "--mesh", "2x1")
    mh = [s["multihost"] for s in ran(res, "global partition")]
    parts = [read_audio(d / f"mw{i}") for i in range(2)]
    print(f"global partition --mesh 2x1, 2 processes on one card: topics "
          f"{[sorted(p) for p in parts]} ({secs:.1f} s for both, start-up included) {card}")
    for p, m in zip(parts, mh):
        if set(p) != set(m["local_topics"]):
            fail(f"global partition: a process wrote {sorted(p)}, owns {m['local_topics']}")
    if set(parts[0]) & set(parts[1]):
        fail("global partition: a topic written twice")
    audio_diff({**parts[0], **parts[1]}, single, "global partition union vs one process")

    res, _ = fleet("m3", 3)
    codes = sorted(rc for rc, _, _ in res)
    refused = [se for rc, _, se in res if rc]
    print(f"3 processes for 2 groups: exit codes {codes} (expected [0, 0, 1])")
    if codes != [0, 0, 1] or "assigned no groups" not in refused[0]:
        fail("3 processes for 2 groups: not exactly one refused")


#: phase 19's receivers: plan, block, step entry
GRAPH_CASES = (
    ("flagship", BLOCK, "u8"), ("flagship", LIVE_BLOCK, "u8"), ("altrate", ALT_BLOCK, "f32"),
    ("iq plan", IQ_BLOCK, "u8"), ("288k", 57_600, "u8"), ("flagship", 2048, "u8"),
)


def graph_plan(name: str):
    """(plan, scope taps) of a phase-19 case."""
    from sdrreceiver_tpu_torch.flagship import altrate_config, benchmark_config
    from sdrreceiver_tpu_torch.graph.config import parse_ini_text
    from sdrreceiver_tpu_torch.graph.plan import build_plan

    if name == "iq plan":
        return build_plan(parse_ini_text(IQ_INI)), ("main", "g0", "VFO01")
    if name == "288k":
        return build_plan(parse_ini_text(INI_288)), ()
    return build_plan((benchmark_config if name == "flagship" else altrate_config)()), ()


def entry_run(rx, entry: str, blocks) -> tuple[list[dict], list[dict]]:
    """(every output of each block on the host, the exported state after
    each block) of ``rx.step_<entry>`` over ``blocks``."""
    fn = getattr(rx, f"step_{entry}")
    st, outs, states = rx.init_state(), [], []
    for b in blocks:
        st, o = fn(st, b)
        outs.append({k: v.cpu().numpy() for k, v in o.items()})
        states.append(rx.export_state(st))
    return outs, states


def bit_equal(a: list[dict], b: list[dict]) -> bool:
    return len(a) == len(b) and all(
        x.keys() == y.keys() and all(np.array_equal(x[k], y[k]) for k in x) for x, y in zip(a, b))


def step_turns(rxs: dict, entry: str, blocks, reps: int,
               order=("eager", "graph", "graph", "eager")) -> dict[str, list[float]]:
    """Median ms per step of each receiver by CUDA events between
    consecutive steps, in turns (``order``)."""
    states = {k: r.init_state() for k, r in rxs.items()}
    out: dict[str, list[float]] = {k: [] for k in rxs}
    for key in order:
        fn, st = getattr(rxs[key], f"step_{entry}"), states[key]
        for i in range(3):
            st, _ = fn(st, blocks[i % len(blocks)])
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
        torch.cuda.synchronize()
        ev[0].record()
        for i in range(reps):
            st, _ = fn(st, blocks[i % len(blocks)])
            ev[i + 1].record()
        torch.cuda.synchronize()
        states[key] = st
        out[key].append(float(np.median([ev[i].elapsed_time(ev[i + 1]) for i in range(reps)])))
    return out


def peak_mib(make, entry: str, blocks) -> float:
    """Peak device memory (MiB) above what was allocated before, of a
    receiver ``make()`` built and stepped 3 times (its graph captured)."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    rx = make()
    fn, st = getattr(rx, f"step_{entry}"), rx.init_state()
    for i in range(3):
        st, _ = fn(st, blocks[i % len(blocks)])
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**20


def step_rows(rx, entry: str, blocks, calls: int = 10, lockstep: bool = False) -> dict:
    """Per step under ``torch.profiler`` (``cuda/devtime.device_us``, which
    drops the trace's first records and profiles again while a row is not
    whole per call): CUDA rows (kernels, memsets, copies) by name, their
    device µs, the wall ms of the profiled steps, and the wrappers' launch
    counts per step.  ``lockstep``: ``rx`` spans processes, which all
    profile at once (``devtime.lockstep_us``)."""
    from sdrreceiver_tpu_torch.cuda import devtime

    fn = getattr(rx, f"step_{entry}")
    st = {"s": rx.init_state(), "i": 0, "n": 0}

    def step():
        st["i"] = (st["i"] + 1) % len(blocks)
        st["n"] += 1
        st["s"], _ = fn(st["s"], blocks[st["i"]])

    before = path_launches(rx)
    wall: dict = {}
    us, rows = (devtime.lockstep_us if lockstep else devtime.device_us)(step, calls, wall=wall)
    after = path_launches(rx)
    return {"rows": rows, "device_us": us, "wall_ms": wall["ms"],
            "launched": {k: (after[k] - before[k]) / st["n"] for k in after}}


def row_kinds(rows: dict) -> dict[str, float]:
    """Per-step counts of the DC kernel, the mix-cascade kernel, memsets,
    NCCL kernels and every CUDA row."""
    def n(f):
        return sum(c for k, c in rows.items() if f(k))
    return {"dc_": n(lambda k: "dc_ingest_kernel" in k),
            "mix_cascade": n(lambda k: "mix_cascade_kernel" in k),
            "memset": n(lambda k: "memset" in k.lower()),
            "nccl": n(lambda k: "nccl" in k.lower()), "rows": n(lambda k: True)}


def phase_graphs(dev, card: str, reps: int) -> dict:
    """19. Every single-device step entry as one CUDA graph, against the
    eager step (``cuda_graphs=False``) on the same blocks."""
    from sdrreceiver_tpu_torch.core.runtime import run_pipeline
    from sdrreceiver_tpu_torch.graph.compiler import CompiledReceiver

    out = {}
    for name, block, entry in GRAPH_CASES:
        plan, taps = graph_plan(name)
        n = 4 if block >= 100_000 else 8
        raw = torch.tensor(plan_stream(plan, n, block, seed=19), device=dev)
        blocks = raw if entry == "u8" else raw.float() - 127.0
        what = f"graphs {name} step_{entry} block {block}"

        def make(graphs: bool = True):
            return CompiledReceiver(plan, block, emit_taps=taps, device=dev, cuda_graphs=graphs)

        rxs = {"graph": make(), "eager": make(False)}
        got, g_states = entry_run(rxs["graph"], entry, blocks)
        launches = path_launches(rxs["graph"])
        ref, e_states = entry_run(rxs["eager"], entry, blocks)
        keys = sorted(got[0])
        same = bit_equal(got, ref) and bit_equal(g_states, e_states)
        print(f"{what}: graph vs eager over {n} blocks, outputs {keys} and exported state "
              f"bit-equal: {same}; launches {launches} (expected {n} each)")
        if not same or any(v != n for v in launches.values()):
            fail(f"{what}: the graph differs from the eager step or missed a launch")
        st, many = getattr(rxs["graph"], f"step_many_{entry}")(rxs["graph"].init_state(),
                                                                 blocks[:4])
        burst = [{k: v.cpu().numpy() for k, v in o.items()}
                 for o in rxs["graph"].unstack_outputs(many, 4)]
        same = bit_equal(burst, got[:4]) and bit_equal([rxs["graph"].export_state(st)],
                                                        g_states[3:4])
        print(f"{what}: step_many_{entry} k=4 vs 4 graph steps bit-equal: {same}")
        if not same:
            fail(f"{what}: the burst graph differs from 4 graph steps")

        turns = step_turns(rxs, entry, blocks, reps)
        ms = {k: float(np.mean(v)) for k, v in turns.items()}
        rt = {k: 1000.0 * block / plan.fs / v for k, v in ms.items()}
        prof = {k: step_rows(r, entry, blocks) for k, r in rxs.items()}
        kinds = {k: row_kinds(p["rows"]) for k, p in prof.items()}
        mem = {"eager": peak_mib(lambda: make(False), entry, blocks),
               "graph": peak_mib(make, entry, blocks)}
        for k in ("eager", "graph"):
            # idle share: device time against the step's time outside the profiler
            print(f"{what} {k}: {ms[k]:.4f} ms/step (medians in turns {turns[k]}), realtime "
                  f"x{rt[k]:.2f}; profiled: {prof[k]['wall_ms']:.4f} ms/step, device "
                  f"{prof[k]['device_us']:.1f} us over {kinds[k]['rows']:g} CUDA rows, idle "
                  f"share {1.0 - prof[k]['device_us'] / 1e3 / ms[k]:.3f}; rows "
                  f"{kinds[k]}; wrapper launches per step {prof[k]['launched']}; peak device "
                  f"memory {mem[k]:.1f} MiB {card}")
        for kind in ("dc_", "mix_cascade", "memset"):
            if kinds["graph"][kind] != kinds["eager"][kind]:
                fail(f"{what}: a replay runs {kinds['graph'][kind]:g} {kind} rows, the eager "
                     f"step {kinds['eager'][kind]:g}")
        per_step = {"dc_": prof["graph"]["launched"].get("dc_ingest", 0.0),
                    "mix_cascade": sum(v for k, v in prof["graph"]["launched"].items()
                                       if k.startswith("mix_cascade"))}
        if any(per_step[k] != kinds["graph"][k] for k in per_step):
            fail(f"{what}: the wrappers' counts {per_step} are not the profiler's {kinds['graph']}")
        out[(name, block)] = {"ms": ms, "rt": rt, "kinds": kinds, "mem": mem,
                              "device_us": {k: p["device_us"] for k, p in prof.items()},
                              "profiled_ms": {k: p["wall_ms"] for k, p in prof.items()}}
        if name == "altrate":
            # the offline runtime as process-file drives it, host f32 blocks,
            # --burst 1 and 4 in turns, each receiver's graphs captured first
            host = [b.cpu().numpy() for b in blocks] * 2
            rts = {1: [], 4: []}
            rx_b = {1: make(), 4: make()}
            for b in rx_b:
                run_pipeline(rx_b[b], iter(host), lambda o: 0, burst=b)
            for b in (1, 4, 4, 1):
                m = run_pipeline(rx_b[b], iter(host), lambda o: 0, burst=b)
                rts[b].append(m.samples_per_second / 1e6)
            print(f"{what}: run_pipeline over {len(host)} host blocks, Msamples/s "
                  f"--burst 1 {rts[1]}, --burst 4 {rts[4]} (graphs captured before) {card}")
            out["burst_msps"] = rts
    return out


#: phase 20's sharded receivers: plan, block, mesh shapes; the flagship
#: cases are timed and profiled
MESH_GRAPH_CASES = (
    ("flagship", BLOCK, ((4, 1), (2, 2), (1, 4))),
    ("flagship", LIVE_BLOCK, ((4, 1), (2, 2), (1, 4))),
    ("iq plan", IQ_BLOCK, ((2, 2),)),
    ("cband66", 384_000, ((2, 4),)),
)


def mesh_layouts(dev) -> list[tuple[str, object]]:
    """(name, n -> n devices): the card n times, and the four cards
    (repeated past four) where there are."""
    from sdrreceiver_tpu_torch.dist import local_devices

    layouts = [("one card", lambda n: [dev] * n)]
    if torch.cuda.device_count() >= 4:
        layouts.append(("four cards", lambda n: local_devices(n, "cuda")))
    return layouts


def phase_mesh_graphs(dev, card: str, reps: int, layouts=None) -> dict:
    """20. Every step entry of the sharded receiver in one process as CUDA
    graphs, one per phase and card (``dist/meshgraph.py``), against the
    eager mesh step (``cuda_graphs=False``) on the same blocks, on
    ``layouts`` (default :func:`mesh_layouts`)."""
    from sdrreceiver_tpu_torch.dist import ShardedReceiver, make_mesh
    from sdrreceiver_tpu_torch.graph.config import parse_ini_text
    from sdrreceiver_tpu_torch.graph.plan import build_plan

    out = {}
    n = 4
    for name, block, shapes in MESH_GRAPH_CASES:
        if name == "cband66":
            plan, taps = build_plan(parse_ini_text(cband_ini(66))), ()
        else:
            plan, taps = graph_plan(name)
        blocks = torch.tensor(plan_stream(plan, n, block, seed=20), device=dev)
        for lname, devs_of in layouts or mesh_layouts(dev):
            for shape in shapes:
                devs = devs_of(shape[0] * shape[1])
                what = f"mesh graphs {name} block {block} {shape[0]}x{shape[1]} ({lname})"

                def make(graphs: bool = True):
                    return ShardedReceiver(plan, make_mesh(*shape, devs), block, emit_taps=taps,
                                           cuda_graphs=graphs)

                rxs = {"graph": make(), "eager": make(False)}
                got, g_states = entry_run(rxs["graph"], "u8", blocks)
                launches = path_launches(rxs["graph"])
                ref, e_states = entry_run(rxs["eager"], "u8", blocks)
                eager_launches = path_launches(rxs["eager"])
                (entry,) = rxs["graph"]._graphs._entries.values()
                n_graphs = 0 if entry.graph is None else entry.graph.graphs
                n_moves = len(entry.body.transfers.bufs)
                same = bit_equal(got, ref) and bit_equal(g_states, e_states)
                print(f"{what}: graph vs eager over {n} blocks, outputs {sorted(got[0])} and "
                      f"exported state bit-equal: {same}; launches graph {launches}, eager "
                      f"{eager_launches} (expected {n} each); a replay runs {n_graphs} graphs "
                      f"and {n_moves} transfers on {len(rxs['graph'].mesh.local())} device(s)")
                if not same or launches != eager_launches or any(v != n for v in launches.values()):
                    fail(f"{what}: the graphs differ from the eager mesh step or missed a launch")
                gx = rxs["graph"]
                st, many = gx.step_many_u8(gx.init_state(), blocks[:4])
                burst = [{k: v.cpu().numpy() for k, v in o.items()}
                         for o in gx.unstack_outputs(many, 4)]
                same = bit_equal(burst, got[:4]) and bit_equal([gx.export_state(st)],
                                                                g_states[3:4])
                print(f"{what}: step_many_u8 k=4 vs 4 graph steps bit-equal: {same}")
                if not same:
                    fail(f"{what}: the burst graphs differ from 4 graph steps")
                if name != "flagship":
                    continue
                turns = step_turns(rxs, "u8", blocks, reps)
                ms = {k: float(np.mean(v)) for k, v in turns.items()}
                prof = {k: step_rows(r, "u8", blocks) for k, r in rxs.items()}
                kinds = {k: row_kinds(p["rows"]) for k, p in prof.items()}
                mem = {"eager": peak_mib(lambda: make(False), "u8", blocks),
                       "graph": peak_mib(make, "u8", blocks)}
                for k in ("eager", "graph"):
                    print(f"{what} {k}: {ms[k]:.4f} ms/step (medians in turns {turns[k]}), "
                          f"realtime x{1000.0 * block / plan.fs / ms[k]:.2f}; profiled: "
                          f"{prof[k]['wall_ms']:.4f} ms/step, device {prof[k]['device_us']:.1f} us "
                          f"over {kinds[k]['rows']:g} CUDA rows, idle share "
                          f"{1.0 - prof[k]['device_us'] / 1e3 / ms[k]:.3f}; rows {kinds[k]}; "
                          f"wrapper launches per step {prof[k]['launched']}; peak device memory "
                          f"{mem[k]:.1f} MiB {card}")
                per_step = sum(prof["graph"]["launched"].values())
                if kinds["graph"]["mix_cascade"] != kinds["eager"]["mix_cascade"] \
                        or kinds["graph"]["mix_cascade"] != per_step or per_step != shape[0]:
                    fail(f"{what}: a replay runs {kinds['graph']['mix_cascade']:g} mix_cascade "
                         f"rows, the eager step {kinds['eager']['mix_cascade']:g}, the wrappers "
                         f"count {per_step:g}")
                out[(block, lname, shape)] = {
                    "ms": ms, "mem": mem, "kinds": kinds, "graphs": n_graphs,
                    "transfers": n_moves,
                    "device_us": {k: p["device_us"] for k, p in prof.items()}}
    return out


def phase_mesh_cli(dev, card: str) -> dict:
    """20 (end). ``run --mesh 2x1`` over a loopback rtl_tcp server at the
    live block, paced: its ZMQ audio against the mesh receiver's
    ``step_u8`` on the same bytes; ``bench --mesh 4x1``; and a capture that
    fails raises."""
    from sdrreceiver_tpu_torch.dist import ShardedReceiver

    d = WORK / "mesh_live"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    n = 12
    raw, tones = flagship_stream(n, LIVE_BLOCK, seed=20)
    watch = sorted(tones)[:3]
    zport = free_port()
    srv = LoopbackRtlTcp(list(raw), interval=LIVE_BLOCK / 1_536_000)
    ini = d / "rtl.ini"
    ini.write_text(flagship_ini(zport, f"127.0.0.1:{srv.port}"))
    sub = Subscriber(zport, watch)
    summary, rx = run_live(["-s", ini, "--device", DEVICE, "--block", LIVE_BLOCK,
                            "--max-blocks", n, "--mesh", "2x1"])
    frames = sub.close()
    srv.join(timeout=15)
    launches = path_launches(rx)
    print(f"run --mesh 2x1 over rtl_tcp, paced: {summary['blocks']} blocks of {rx.block} on "
          f"{[str(x) for x in rx.mesh.local()]}, cuda_graphs {summary['cuda_graphs']}, ring "
          f"{summary['ring']}, rtl_tcp {summary['rtl_tcp']}; launches {launches} (expected "
          f"{n} each); host_ms_per_block p50 {summary['host_ms_per_block']['p50']} {card}")
    if summary["blocks"] != n or summary["ring"]["dropped"] or summary["rtl_tcp"]["reconnects"] \
            or not summary["cuda_graphs"] or rx.n_time != 2 or len(launches) != 2 \
            or any(v != n for v in launches.values()):
        fail("run --mesh 2x1: blocks dropped, no graphs, or kernels not launched once a block")
    direct = ShardedReceiver(rx.plan, (2, 1), rx.block, device=DEVICE)
    ref = steps_audio(direct, torch.tensor(raw, device=dev))
    rates = direct.rates()
    got: dict[str, list[np.ndarray]] = {t: [] for t in watch}
    for f in frames:
        topic = f[0].decode()
        if len(f) != 3 or topic not in got or struct.unpack("<I", f[1])[0] != rates[f"audio/{topic}"]:
            fail(f"run --mesh 2x1: malformed frame {[len(x) for x in f]} {f[:2]}")
        got[topic].append(np.frombuffer(f[2], np.int16))
    for topic, parts in got.items():
        k = len(parts)
        same = k >= n - 1 and all(np.array_equal(a, b) for a, b in
                                  zip(parts, [o[f"audio/{topic}"] for o in ref[n - k:]]))
        print(f"run --mesh 2x1 ZMQ {topic}: {k} frames (of {n}), bit-equal to the mesh "
              f"receiver's step_u8 on the same bytes: {same}")
        if not same:
            fail(f"run --mesh 2x1: {topic} frames differ from the mesh step_u8")
        check_tone(np.concatenate(parts[-4:]), rates[f"audio/{topic}"], tones[topic],
                   f"run --mesh 2x1 {topic}")

    bench_ini = d / "flag.ini"
    bench_ini.write_text(flagship_ini(free_port()))
    out = {"run": summary}
    for block in (LIVE_BLOCK, BLOCK):
        r = cli("bench", "-s", bench_ini, "--device", DEVICE, "--mesh", "4x1", "--block", block,
                "--blocks", 20)
        print(f"bench --mesh 4x1 flagship block {block}: mode {r['mode']}, cuda_graphs "
              f"{r['cuda_graphs']}, {r['msamples_per_second']} Msamples/s, realtime "
              f"x{r['realtime_factor']} (device {r['device']}) {card}")
        if r["mode"] != "sharded" or not r["cuda_graphs"] or r["block_samples"] != block:
            fail("bench --mesh 4x1: not the sharded receiver on its graphs")
        out[block] = r

    # no fallback: a host read inside a phase breaks the capture, which
    # raises and ends the process (in a process of its own)
    res = subprocess.run([sys.executable, str(REPO / "chip_smoke.py"), "--capture-failure"],
                         capture_output=True, text=True, env=dict(os.environ, PYTHONPATH=str(REPO)),
                         cwd=str(REPO), timeout=300, check=False)
    last = (res.stderr.strip().splitlines() or [""])[-1]
    print(f"a host read inside a phase of a 2x1 mesh step: the process exited {res.returncode} "
          f"({last[:160]})")
    if res.returncode <= 0 or "capture" not in res.stderr or "stepped" in res.stdout:
        fail("a capture that cannot hold the mesh step did not fail the step")
    return out


def capture_failure_child() -> int:
    """``chip_smoke.py --capture-failure``: a 2x1 flagship mesh whose step
    reads a device value on the host inside a phase; its first step must
    raise (the capture fails), which ends this process non-zero."""
    from sdrreceiver_tpu_torch.dist import ShardedReceiver
    from sdrreceiver_tpu_torch.flagship import benchmark_config
    from sdrreceiver_tpu_torch.graph.plan import build_plan

    rx = ShardedReceiver(build_plan(benchmark_config()), (2, 1), LIVE_BLOCK, device=DEVICE)
    gather = rx._gather_time

    def syncing(per_shard):
        zs = gather(per_shard)
        next(iter(zs.values()))[0].sum().item()
        return zs

    rx._gather_time = syncing
    raw = torch.full((2 * LIVE_BLOCK,), 127, dtype=torch.uint8, device=DEVICE)
    rx.step_u8(rx.init_state(), raw)
    torch.cuda.synchronize()
    print("stepped: the capture did not fail")
    return 0


def proc_plan(name: str):
    """Phase 21's plans: the flagship, or the 66-channel plan
    (:func:`cband_ini`)."""
    from sdrreceiver_tpu_torch.flagship import benchmark_config
    from sdrreceiver_tpu_torch.graph.config import parse_ini_text
    from sdrreceiver_tpu_torch.graph.plan import build_plan

    return build_plan(benchmark_config() if name == "flagship" else parse_ini_text(cband_ini()))


def proc_mesh(coord: str, pid: int, n_local: int, n_chan: int = 1, n_proc: int = 2,
              plan: str = "flagship"):
    """(mesh, plan): this process joined to a gloo group of ``n_proc`` at
    ``coord`` as ``pid``, and the ``--partition global`` mesh of ``n_chan``
    columns over every process's ``n_local`` cards (1: the card; 2: two
    distinct cards, a global 4x1 of two processes), laid out as the JAX
    package's: with one card a process and ``n_chan`` 2, a time row spans
    two processes (a global 1x2, or 2x2 of four)."""
    from sdrreceiver_tpu_torch.dist import local_devices, multihost

    multihost.initialize(coord, n_proc, pid)
    devs = [torch.device("cuda", torch.cuda.current_device())] if n_local == 1 \
        else local_devices(n_local, "cuda")
    return multihost.global_mesh(n_chan, devs), proc_plan(plan)


def mesh_name(mesh) -> str:
    return f"{mesh.shape['time']}x{mesh.shape['chan']}"


def proc_graphs_child(argv: list[str]) -> int:
    """``chip_smoke.py --procgraphs COORD PID N_LOCAL [N_CHAN N_PROC PLAN
    BLOCKS]``: one of phase 21's processes (default: of two, the flagship,
    one column, blocks ``1536000,384000``).  On the global mesh
    (:func:`proc_mesh`) at each block: the sharded receiver with graphs per phase and card (the
    default) against the eager one (``cuda_graphs=False``) on the same
    blocks, the burst, the launches, step ms in turns, the profiler's rows
    (both processes profile at once) and peak memory; a last line of JSON
    with the numbers.  Both processes make the same steps in the same
    order: every step exchanges data between them.  Where the processes
    hold distinct cards the exchanges are NCCL collectives inside the
    graphs: then a third receiver, the same graphs with the exchanges
    staged through gloo (``ProcessSpan(mesh, transport="staged")``), is
    held bit-equal too and timed in the same turns; a replay must make no
    host exchange and run NCCL kernels, every per-shard ``mix_cascade``
    site must agree with its plain version exactly.  Sharing a card, the
    exchanges must be gloo's.  Where a time row spans processes, each
    process's split bucket steps compute only its own channel ranges.  The
    outputs whose topics a process publishes go to ``build/smoke/procs/``,
    for the parent to hold their union against a one-process mesh."""
    from sdrreceiver_tpu_torch.dist import multihost

    coord, pid, n_local = argv[0], int(argv[1]), int(argv[2])
    n_chan, n_proc = (int(argv[3]), int(argv[4])) if len(argv) > 4 else (1, 2)
    plan_name = argv[5] if len(argv) > 5 else "flagship"
    blocks = [int(b) for b in argv[6].split(",")] if len(argv) > 6 else [BLOCK, LIVE_BLOCK]
    mesh, plan = proc_mesh(coord, pid, n_local, n_chan, n_proc, plan_name)
    cards = [str(d) for d in mesh.local()]
    # each case's receivers are gone before the process group is left: a
    # graph that captured NCCL collectives holds their communicator
    out = [proc_graphs_case(mesh, plan, block, cards, plan_name) for block in blocks]
    multihost.shutdown()
    print(json.dumps({"process_id": pid, "cards": cards, "mesh": mesh_name(mesh),
                      "plan": plan_name, "cases": out}))
    return 0


def proc_outputs_path(plan_name: str, mesh_shape: str, block: int, pid: int) -> pathlib.Path:
    return WORK / "procs" / f"{plan_name}_{mesh_shape}_{block}_p{pid}.npz"


def proc_graphs_case(mesh, plan, block: int, cards: list[str], plan_name: str = "flagship") -> dict:
    """One block size of :func:`proc_graphs_child`: its checks, and its
    numbers."""
    from sdrreceiver_tpu_torch.dist import ShardedReceiver, multihost, sharded

    pid, n = mesh.rank, 4
    n_proc = len({r for row in mesh.ranks for r in row})
    blocks = torch.tensor(plan_stream(plan, n, block, seed=21), device=mesh.home)

    def make(graphs: bool = True, transport: str | None = None):
        rx = ShardedReceiver(plan, mesh, block, cuda_graphs=graphs)
        if transport is not None:
            rx._span = multihost.ProcessSpan(mesh, transport=transport)
        return rx

    rxs = {"graph": make(), "eager": make(False)}
    nccl = rxs["graph"].exchange == "nccl"
    if nccl:
        rxs["gloo"] = make(transport="staged")
    exchange = {k: r.exchange for k, r in rxs.items()}
    what = (f"process {pid} of {n_proc}, {plan_name} global {mesh_name(mesh)} on {cards} "
            f"(visible cards {os.environ.get('CUDA_VISIBLE_DEVICES', 'all')}), block {block}, "
            f"exchanges {exchange}")
    if exchange != ({"graph": "nccl", "eager": "nccl", "gloo": "gloo"} if nccl
                    else {"graph": "gloo", "eager": "gloo"}):
        fail(f"{what}: not the transport its cards call for")
    computed: dict[str, int] = {}  # channels of the split bucket steps of the eager step
    step_part = sharded._ChanSlice._bucket_step

    def counting(self, g, bi, *args):
        key = f"g{g.index}/b{bi}"
        computed[key] = computed.get(key, 0) + g.buckets[bi].channels
        return step_part(self, g, bi, *args)

    runs = {}
    for k, r in rxs.items():
        if k == "eager":
            sharded._ChanSlice._bucket_step = counting
        try:
            runs[k] = entry_run(r, "u8", blocks)
        finally:
            sharded._ChanSlice._bucket_step = step_part
        print(f"{what}: {k} stepped {n} blocks", flush=True)
    got, g_states = runs["graph"]
    mine = {bk: sum(hi - lo for lo, hi, _, part in parts if part is not None)
            for bk, parts in rxs["graph"]._chan_parts.items()}
    whole = {bk: parts[-1][1] for bk, parts in rxs["graph"]._chan_parts.items()}
    per = {bk: c // n for bk, c in computed.items()}
    print(f"{what}: channels of the split buckets computed here per step {per} (own ranges "
          f"{mine}, of {whole})", flush=True)
    if per != mine \
            or (len(mesh.row_ranks()) > 1 and not all(mine[bk] < whole[bk] for bk in mine)):
        fail(f"{what}: the split bucket steps did not compute exactly this process's ranges")
    owner = multihost.output_key_owner(plan, n_proc)
    path = proc_outputs_path(plan_name, mesh_name(mesh), block, pid)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **{f"{i}|{k}": v for i, o in enumerate(got) for k, v in o.items()
                      if multihost.key_owner(owner, k) == pid})
    launches = {k: path_launches(r) for k, r in rxs.items()}
    (entry,) = rxs["graph"]._graphs._entries.values()
    t = entry.body.transfers
    span = rxs["graph"]._span
    per_replay = {"graphs": 0 if entry.graph is None else entry.graph.graphs,
                  "transfers": len(t.bufs), "exchanges": t.exchanges,
                  "host_exchanges": len(t.hosts), "collectives": len(t.collectives),
                  # a halo this process neither sends nor receives launches nothing
                  "nccl_calls": sum(x.kind != "halo" or bool(span.to) or span.prev is not None
                                    for x in t.collectives)}
    same = {k: bit_equal(got, o) and bit_equal(g_states, st)
            for k, (o, st) in runs.items() if k != "graph"}
    print(f"{what}: graph vs {' and '.join(same)} over {n} blocks, outputs {len(got[0])} keys "
          f"and exported state bit-equal: {same}; launches {launches} (expected {n} each); a "
          f"replay runs {per_replay}", flush=True)
    if not all(same.values()) or any(v != launches["graph"] for v in launches.values()) \
            or not launches["graph"] or any(v != n for v in launches["graph"].values()) \
            or not per_replay["exchanges"]:
        fail(f"{what}: the graphs differ from the eager step or missed a launch")
    if per_replay["host_exchanges"] != (0 if nccl else per_replay["exchanges"]):
        fail(f"{what}: a replay makes {per_replay['host_exchanges']} host exchanges")
    gx = rxs["graph"]
    st, many = gx.step_many_u8(gx.init_state(), blocks[:4])
    burst = [{k: v.cpu().numpy() for k, v in o.items()} for o in gx.unstack_outputs(many, 4)]
    same = bit_equal(burst, got[:4]) and bit_equal([gx.export_state(st)], g_states[3:4])
    print(f"{what}: step_many_u8 k=4 vs 4 graph steps bit-equal: {same}", flush=True)
    if not same:
        fail(f"{what}: the burst graphs differ from 4 graph steps")
    vs = sites_vs_plain(gx, what, reps=20 if len(mesh.row_ranks()) > 1 else 0)
    err = vs["err"]
    if nccl and err != 0:
        fail(f"{what}: a per-shard mix_cascade site is {err:.3e} from its plain version")
    order = ("eager", "graph", "gloo", "gloo", "graph", "eager") if nccl else \
        ("eager", "graph", "graph", "eager")
    turns = step_turns(rxs, "u8", blocks, 20, order)
    ms = {k: float(np.mean(v)) for k, v in turns.items()}
    prof = {k: step_rows(r, "u8", blocks, lockstep=True) for k, r in rxs.items()}
    kinds = {k: row_kinds(p["rows"]) for k, p in prof.items()}
    mem = {"eager": peak_mib(lambda: make(False), "u8", blocks), "graph": peak_mib(make, "u8", blocks)}
    if nccl:
        mem["gloo"] = peak_mib(lambda: make(transport="staged"), "u8", blocks)
    idle = {k: 1.0 - prof[k]["device_us"] / 1e3 / ms[k] for k in ms}
    for k in rxs:
        print(f"{what} {k}: {ms[k]:.4f} ms/step (medians in turns {turns[k]}); profiled: "
              f"{prof[k]['wall_ms']:.4f} ms/step, device {prof[k]['device_us']:.1f} us over "
              f"{kinds[k]['rows']:g} CUDA rows, idle share {idle[k]:.3f}; rows {kinds[k]}; "
              f"wrapper launches per step {prof[k]['launched']}; peak device memory "
              f"{mem[k]:.1f} MiB", flush=True)
    per_step = sum(prof["graph"]["launched"].values())
    if any(kinds[k]["mix_cascade"] != kinds["graph"]["mix_cascade"] for k in kinds) \
            or kinds["graph"]["mix_cascade"] != per_step \
            or per_step != len(mesh.rows()) * len(gx._fronts):
        fail(f"{what}: a replay runs {kinds['graph']['mix_cascade']:g} mix_cascade rows, "
             f"the other steps {[kinds[k]['mix_cascade'] for k in kinds]}, the wrappers "
             f"count {per_step:g}")
    if nccl and (kinds["graph"]["nccl"] != per_replay["nccl_calls"] or kinds["gloo"]["nccl"]):
        fail(f"{what}: a replay runs {kinds['graph']['nccl']:g} NCCL rows for "
             f"{per_replay['nccl_calls']} collectives that launch (the gloo graphs "
             f"{kinds['gloo']['nccl']:g})")
    return {"block": block, "err": err, "ms": ms, "turns": turns, "idle": idle,
            "mem": mem, "exchange": exchange["graph"], "launches": launches["graph"],
            "site_ms": vs["ms"], "site_plain_ms": vs["plain_ms"], "channels": mine,
            "sites": {k: t for k, (_, t) in gx.mix_cascades().items()},
            "kinds": kinds, **per_replay,
            "device_us": {k: p["device_us"] for k, p in prof.items()},
            "profiled_ms": {k: p["wall_ms"] for k, p in prof.items()}}


def phase_proc_graphs(card: str, n_local: int = 1, distinct: bool = False, n_chan: int = 1,
                      n_proc: int = 2, plan: str = "flagship",
                      blocks: tuple[int, ...] = (BLOCK, LIVE_BLOCK),
                      n_cards: int | None = None) -> list[dict]:
    """21. The sharded receiver's step entries as CUDA graphs on a mesh
    across processes: ``n_proc`` processes (:func:`proc_graphs_child`) of
    ``n_local`` devices each, all of them the one card, or (``distinct``)
    each process ``n_cards`` cards of its own (default ``n_local``; 1: its
    card held ``n_local`` times), on a global mesh of ``n_chan`` columns;
    each fails on its own checks.  Where ``n_chan`` > 1 the union of the
    topics the processes publish is then held bit-equal to the
    one-process mesh of the same shape over the same cards (or the one
    card).  Each process's cases."""
    coord = f"127.0.0.1:{free_port()}"
    envs = None
    n_cards = n_cards or n_local
    if distinct:
        envs = [{"CUDA_VISIBLE_DEVICES": ",".join(str(n_cards * i + j) for j in range(n_cards))}
                for i in range(n_proc)]
    shutil.rmtree(WORK / "procs", ignore_errors=True)
    t0 = time.perf_counter()
    res = processes([["--procgraphs", coord, i, n_local, n_chan, n_proc, plan,
                      ",".join(map(str, blocks))] for i in range(n_proc)], timeout=600, envs=envs)
    secs = time.perf_counter() - t0
    out = []
    for i, (rc, so, se) in enumerate(res):
        print("\n".join("  " + line for line in so.strip().splitlines()[:-1]))
        if rc:
            fail(f"phase 21: process {i} exited {rc}: {se[-3000:]}")
        out.append(json.loads(so.strip().splitlines()[-1]))
    print(f"phase 21, {plan} global {out[0]['mesh']} of {n_proc} processes, {n_local} card(s) a "
          f"process{', distinct' if distinct else ''}: every process passed ({secs:.1f} s, "
          f"start-up included) {card}")
    if n_chan > 1:
        out[0]["union_ms"] = {block: proc_union(plan, out[0]["mesh"], n_proc, n_local, distinct,
                                                block, card, n_cards) for block in blocks}
    return out


def proc_union(plan_name: str, shape: str, n_proc: int, n_local: int, distinct: bool,
               block: int, card: str, n_cards: int) -> dict:
    """The union of the outputs whose topics each process of a global mesh
    publishes (:func:`proc_graphs_case` saved them) against the one-process
    mesh of the same shape over the same cards (distinct: each position on
    the card its process held there; else the one card), on the same
    blocks: bit-equal.  Also times that mesh and one device in turns; their
    ms."""
    from sdrreceiver_tpu_torch.dist import ShardedReceiver, make_mesh, multihost
    from sdrreceiver_tpu_torch.graph.compiler import CompiledReceiver

    plan = proc_plan(plan_name)
    n_time, n_chan = map(int, shape.split("x"))
    devs = ([torch.device("cuda", k // n_local * n_cards + k % n_local % n_cards)
             for k in range(n_proc * n_local)] if distinct
            else [torch.device(DEVICE)] * (n_time * n_chan))
    blocks = torch.tensor(plan_stream(plan, 4, block, seed=21), device=devs[0])
    rx = ShardedReceiver(plan, make_mesh(n_time, n_chan, devs), block)
    ref, _ = entry_run(rx, "u8", blocks)
    owner = multihost.output_key_owner(plan, n_proc)
    want = {f"{i}|{k}": v for i, o in enumerate(ref) for k, v in o.items()
            if multihost.key_owner(owner, k) is not None}
    union: dict = {}
    for pid in range(n_proc):
        with np.load(proc_outputs_path(plan_name, shape, block, pid)) as z:
            got = {k: z[k] for k in z.files}
        if set(got) & set(union):
            fail(f"{plan_name} global {shape}: an output published by two processes")
        union.update(got)
    same = union.keys() == want.keys() and all(np.array_equal(union[k], want[k]) for k in want)
    one = CompiledReceiver(plan, block, device=devs[0])
    turns = step_turns({"mesh": rx, "one": one}, "u8", blocks, 20, ("one", "mesh", "mesh", "one"))
    ms = {k: float(np.mean(v)) for k, v in turns.items()}
    print(f"{plan_name} global {shape} of {n_proc} processes, block {block}: the union of the "
          f"{len(union) // 4} outputs a block the processes publish vs the one-process {shape} "
          f"mesh over {sorted({str(d) for d in devs})}, 4 blocks, bit-equal: {same}; that mesh "
          f"{ms['mesh']:.4f} ms/step, one device {ms['one']:.4f} ms/step (in turns "
          f"{turns}) {card}", flush=True)
    if not same:
        fail(f"{plan_name} global {shape} block {block}: the processes' union differs from the "
             f"one-process mesh")
    return ms


def capture_failure_procs_child(argv: list[str]) -> int:
    """``chip_smoke.py --capture-failure-procs COORD PID``: a global 2x1
    flagship mesh over two processes (on the card, or each on its own card
    when the caller hides the others), process 0's step reading a device
    value on the host inside a phase: its capture fails and ends it
    non-zero; process 1's next exchange then finds its peer gone, which
    ends it non-zero too: its gloo call raises, or its replay's NCCL
    kernels wait until ``multihost.TIMEOUT_S`` (30 s here) and the NCCL
    group is aborted."""
    from sdrreceiver_tpu_torch.dist import ShardedReceiver, multihost

    multihost.TIMEOUT_S = 30
    mesh, plan = proc_mesh(argv[0], int(argv[1]), 1)
    try:  # the process group is left as the CLI leaves it
        rx = ShardedReceiver(plan, mesh, LIVE_BLOCK)
        print(f"exchange {rx.exchange}", flush=True)
        if mesh.rank == 0:
            gather = rx._gather_time

            def syncing(per_shard):
                zs = gather(per_shard)
                next(iter(zs.values()))[0].sum().item()
                return zs

            rx._gather_time = syncing
        raw = torch.full((2 * LIVE_BLOCK,), 127, dtype=torch.uint8, device=mesh.home)
        st = rx.init_state()
        for _ in range(3):
            st, _ = rx.step_u8(st, raw)
        torch.cuda.synchronize()
    finally:
        multihost.shutdown()
    print("stepped: the capture did not fail")
    return 0


def phase_capture_failure_procs(card: str, distinct: bool = False) -> float:
    """21 (end). No fallback across processes: process 0's capture fails,
    and process 1 then ends on its first exchange without its peer; both
    processes on the card (gloo), or (``distinct``) each on its own card
    (NCCL: process 1's replay waits until the deadline).  The seconds both
    took."""
    coord = f"127.0.0.1:{free_port()}"
    envs = [{"CUDA_VISIBLE_DEVICES": str(i)} for i in (0, 1)] if distinct else None
    t0 = time.perf_counter()
    res = processes([["--capture-failure-procs", coord, i] for i in (0, 1)], timeout=240,
                    envs=envs)
    secs = time.perf_counter() - t0
    (rc0, so0, se0), (rc1, so1, se1) = res
    exchange = "nccl" if distinct else "gloo"
    print(f"a host read inside a phase of process 0 of a global 2x1 mesh "
          f"({'a card a process' if distinct else 'one card'}, {exchange}): exit codes "
          f"{[rc for rc, _, _ in res]} after {secs:.1f} s; the errors:")
    for i, (_, _, se) in enumerate(res):
        errs = [line for line in se.splitlines() if "Error" in line or "error" in line]
        print(f"  process {i}: {[e[:200] for e in errs[-4:]]}")
    tail = [line[:200] for line in se0.strip().splitlines()
            if not line.lstrip().startswith("frame #")][-30:]
    print("  process 0's last lines of stderr (no C++ frames):\n    " + "\n    ".join(tail))
    peer = "NCCL group was aborted" if distinct else "communicate"
    if rc0 <= 0 or "capture" not in se0 or rc1 <= 0 or peer not in se1 \
            or "stepped" in so0 + so1 or f"exchange {exchange}" not in so0 + so1:
        fail(f"a capture that cannot hold the step across processes ({exchange}) did not end "
             f"both processes")
    return secs


def proc_bench(ini: pathlib.Path, extra: list, block: int, exchange, where: str, card: str,
               envs: list[dict] | None = None) -> dict:
    """``bench --coordinator`` over two processes (``envs``: each its own
    visible cards); fails unless both stepped through graphs at ``block``
    with ``exchange`` (each process's ``"exchange"``).  Process 0's
    ``multihost`` summary."""
    coord = f"127.0.0.1:{free_port()}"
    res = processes([["--cli", "bench", "-s", ini, "--device", DEVICE, "--block", block,
                      "--blocks", 20, "--coordinator", coord, "--num-processes", 2,
                      "--process-id", i, *extra] for i in (0, 1)], envs=envs)
    what = f"bench --coordinator {' '.join(map(str, extra)) or '(groups)'}"
    sums = []
    for i, (rc, so, se) in enumerate(res):
        if rc:
            fail(f"{what}: process {i} exited {rc}: {se[-2000:]}")
        sums.append(json.loads(so.strip().splitlines()[-2]))
    mh = [s["multihost"] for s in sums]
    print(f"{what}, 2 processes {where}, flagship block {block}: mode {[s['mode'] for s in sums]}, "
          f"cuda_graphs {[s['cuda_graphs'] for s in sums]}, exchange "
          f"{[s.get('exchange') for s in sums]}, Msamples/s per process "
          f"{mh[0]['sps_per_host_msps']}, sps_1_full_plan "
          f"{[m['sps_1_full_plan'] for m in mh]} Msamples/s, eff(2) {mh[0]['eff']} (ceiling "
          f"{mh[0]['eff_ceiling']}), realtime {[s['realtime_factor'] for s in sums]} {card}")
    if not all(s["cuda_graphs"] for s in sums) or any(s["block_samples"] != block for s in sums):
        fail(f"{what}: not on graphs or not at block {block}")
    if [s.get("exchange") for s in sums] != [exchange, exchange]:
        fail(f"{what}: exchange {[s.get('exchange') for s in sums]} {where}, not {exchange}")
    return mh[0]


def proc_run(d: pathlib.Path, dev, shape: str, exchange: str, where: str, card: str,
             envs: list[dict] | None = None, devs=None) -> list[dict]:
    """``run --coordinator --partition global --mesh SHAPE`` over two
    processes, each from its own loopback rtl_tcp server of the same bytes
    to its own ZMQ port, paced: no drop, every block through graphs with
    ``exchange``, each process's ZMQ audio bit-equal to its own topics of
    the one-process mesh of that shape (over ``devs``, default the card)
    stepping the same bytes.  Each process's summary."""
    from sdrreceiver_tpu_torch.dist import ShardedReceiver, make_mesh, multihost
    from sdrreceiver_tpu_torch.flagship import benchmark_config
    from sdrreceiver_tpu_torch.graph.plan import build_plan

    n = 12
    raw, tones = flagship_stream(n, LIVE_BLOCK, seed=21)
    plan = build_plan(benchmark_config())
    owner = multihost.egress_owner(plan, 2)
    topics = [[s.topic for g in plan.groups if owner[g.index] == i for b in g.buckets
               for s in b.subs] for i in (0, 1)]
    watch = [sorted(t for t in ts if t in tones)[:3] for ts in topics]
    zports = [free_port(), free_port()]
    srvs = [LoopbackRtlTcp(list(raw), interval=LIVE_BLOCK / 1_536_000, delay=3.0) for _ in (0, 1)]
    inis = []
    for i in (0, 1):
        inis.append(d / f"rtl{shape}_{i}.ini")
        inis[i].write_text(flagship_ini(zports[i], f"127.0.0.1:{srvs[i].port}"))
    subs = [Subscriber(zports[i], watch[i]) for i in (0, 1)]
    coord = f"127.0.0.1:{free_port()}"
    res = processes([["--cli", "run", "-s", inis[i], "--device", DEVICE, "--block", LIVE_BLOCK,
                      "--max-blocks", n, "--coordinator", coord, "--num-processes", 2,
                      "--process-id", i, "--partition", "global", "--mesh", shape]
                     for i in (0, 1)], envs=envs)
    frames = [s.close() for s in subs]
    for srv in srvs:
        srv.join(timeout=15)
    n_time, n_chan = map(int, shape.split("x"))
    direct = ShardedReceiver(plan, make_mesh(n_time, n_chan, devs or [dev] * (n_time * n_chan)),
                             LIVE_BLOCK)
    ref = steps_audio(direct, torch.tensor(raw, device=direct.device))
    rates = direct.rates()
    what = f"run --coordinator --partition global --mesh {shape}"
    runs = []
    for i, (rc, so, se) in enumerate(res):
        if rc:
            fail(f"{what}: process {i} exited {rc}: {se[-2000:]}")
        summary = json.loads(so.strip().splitlines()[-2])
        (launches,) = json.loads(so.strip().splitlines()[-1])["launches"]
        print(f"{what} over rtl_tcp, paced, process {i} of 2 {where}: {summary['blocks']} "
              f"blocks, cuda_graphs {summary['cuda_graphs']}, exchange "
              f"{summary.get('exchange')}, ring {summary['ring']}, rtl_tcp {summary['rtl_tcp']}; "
              f"launches {launches} (expected {n} each); host_ms_per_block p50 "
              f"{summary['host_ms_per_block']['p50']} {card}")
        if summary["blocks"] != n or summary["ring"]["dropped"] \
                or summary["rtl_tcp"]["reconnects"] or not summary["cuda_graphs"] \
                or summary.get("exchange") != exchange \
                or any(v != n for v in launches.values()) or not launches:
            fail(f"{what}: process {i} dropped blocks, stepped eagerly, did not exchange "
                 f"through {exchange} or missed a launch")
        got: dict[str, list[np.ndarray]] = {t: [] for t in watch[i]}
        for f in frames[i]:
            topic = f[0].decode()
            if len(f) != 3 or topic not in got \
                    or struct.unpack("<I", f[1])[0] != rates[f"audio/{topic}"]:
                fail(f"{what}: process {i} sent a malformed frame {f[:2]}")
            got[topic].append(np.frombuffer(f[2], np.int16))
        for topic, parts in got.items():
            k = len(parts)
            same = k >= n - 1 and all(np.array_equal(a, b) for a, b in
                                      zip(parts, [o[f"audio/{topic}"] for o in ref[n - k:]]))
            print(f"{what} process {i} ZMQ {topic}: {k} frames (of {n}), bit-equal to the "
                  f"one-process {shape} mesh's step_u8 on the same bytes: {same}")
            if not same:
                fail(f"{what}: process {i}'s {topic} differs from the {shape} mesh step_u8")
        runs.append(summary)
    return runs


def phase_proc_cli(dev, card: str) -> dict:
    """21 (end). First card runs of the CLI across processes: ``bench
    --coordinator`` under both partitions, ``run --coordinator --partition
    global --mesh 2x1`` over loopback rtl_tcp (each process's ZMQ audio
    against its own topics of the one-process 2x1 mesh's ``step_u8`` on the
    same bytes), and a capture that fails in one process of two."""
    d = WORK / "proc_cli"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    out: dict = {"bench": {}}
    bench_ini = d / "flag.ini"
    bench_ini.write_text(flagship_ini(free_port()))
    for partition, extra in (("groups", []),
                             ("global", ["--partition", "global", "--mesh", "2x1"])):
        for block in (LIVE_BLOCK, BLOCK):
            # two processes on one card: NCCL refuses them, the exchanges are gloo's
            out["bench"][(partition, block)] = proc_bench(
                bench_ini, extra, block, None if partition == "groups" else "gloo",
                "on one card", card)
    out["run"] = proc_run(d, dev, "2x1", "gloo", "on one card", card)
    out["capture_failure_s"] = phase_capture_failure_procs(card)
    return out


def proc_cli_cards(card: str) -> dict:
    """21 (distinct cards). The CLI over two processes of a card each, on a
    global 1x2 (a time row across both, its split buckets' channel ranges
    exchanged through NCCL): ``bench --coordinator --partition global
    --mesh 1x2`` at 384,000 and 1,536,000, then ``run`` over loopback
    rtl_tcp, each process's ZMQ audio against the one-process 1x2 mesh over
    the same two cards."""
    d = WORK / "proc_cli_cards"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    envs = [{"CUDA_VISIBLE_DEVICES": str(i)} for i in (0, 1)]
    ini = d / "flag.ini"
    ini.write_text(flagship_ini(free_port()))
    out = {"bench": {block: proc_bench(ini, ["--partition", "global", "--mesh", "1x2"], block,
                                       "nccl", "a card each", card, envs)
                     for block in (LIVE_BLOCK, BLOCK)}}
    out["run"] = proc_run(d, torch.device(DEVICE), "1x2", "nccl", "a card each", card, envs,
                          [torch.device("cuda", i) for i in (0, 1)])
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
    rx_plain = CompiledReceiver(plan, BLOCK, device=dev, use_kernels=False, cuda_graphs=False)
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

    # ---- 15-18. the sharded receiver and the two multi-process partitions ----
    mesh = phase_mesh(dev, card, reps)
    shard_err = max(mesh["err"], phase_cband(dev, card), phase_alt_mesh(alt)["err"])
    phase_multihost(card)

    # ---- 19. the step entries as CUDA graphs ----
    phase_graphs(dev, card, reps)

    # ---- 20. the mesh step entries as CUDA graphs, per phase and card ----
    phase_mesh_graphs(dev, card, reps)
    phase_mesh_cli(dev, card)

    # ---- 21. the mesh step across processes as CUDA graphs ----
    phase_proc_graphs(card)
    # a time row across the two processes: each its own channel ranges
    row = [p["cases"][0] for p in phase_proc_graphs(card, n_chan=2, blocks=(LIVE_BLOCK,))]
    # a process whose devices end one time row and begin the next: the
    # global 2x3 of three processes, each holding the card twice
    ends = [p["cases"][0] for p in phase_proc_graphs(card, n_local=2, n_chan=3, n_proc=3,
                                                     blocks=(LIVE_BLOCK,))]
    if torch.cuda.device_count() >= 2:  # distinct cards: NCCL inside the graphs
        procs_on_cards(card)
    phase_proc_cli(dev, card)

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
        {"name": f"mix_cascade (per-shard merged front, flagship 4x1 mesh on one card, "
                 f"block {BLOCK}: {len(mesh['sites'])} sites of T={mesh['shard_t']}; "
                 f"max_abs_err over every per-shard site of phases 15-17)",
         "route": "cuda", "source": "sdrreceiver_tpu_torch/csrc/mix_cascade.cu",
         "replaces": "sdrreceiver_tpu/pallas/frontend.py:488",
         "also_replaces": "sdrreceiver_tpu/pallas/frontend.py:672",
         "launches": mesh["launches"], "max_abs_err": shard_err,
         "ms": mesh["ms"], "plain_ms": mesh["plain_ms"],
         **timing_keys(devt, [f"mix_cascade flagship mesh 4x1 block {BLOCK} {k}"
                              for k in mesh["sites"]])},
        {"name": f"mix_cascade (per-shard merged front, flagship global 1x2 over two processes "
                 f"on one card, block {LIVE_BLOCK}: one site of "
                 f"T={row[0]['sites']['shard0/front']} in each process, the same shape as the "
                 f"one-device front)",
         "route": "cuda", "source": "sdrreceiver_tpu_torch/csrc/mix_cascade.cu",
         "replaces": "sdrreceiver_tpu/pallas/frontend.py:488",
         "also_replaces": "sdrreceiver_tpu/pallas/frontend.py:672",
         "launches": sum(sum(c["launches"].values()) for c in row),
         "max_abs_err": max(c["err"] for c in row),
         "ms": row[0]["site_ms"], "plain_ms": row[0]["site_plain_ms"],
         **timing_keys(devt, [f"mix_cascade flagship block {LIVE_BLOCK} front"])},
        {"name": f"mix_cascade (per-shard merged front, flagship global 2x3 over three "
                 f"processes holding the card twice each, block {LIVE_BLOCK}: one site of "
                 f"T={ends[0]['sites']['shard0/front']} a time shard, process 1 two)",
         "route": "cuda", "source": "sdrreceiver_tpu_torch/csrc/mix_cascade.cu",
         "replaces": "sdrreceiver_tpu/pallas/frontend.py:488",
         "also_replaces": "sdrreceiver_tpu/pallas/frontend.py:672",
         "launches": sum(sum(c["launches"].values()) for c in ends),
         "max_abs_err": max(c["err"] for c in ends),
         "ms": ends[0]["site_ms"], "plain_ms": ends[0]["site_plain_ms"],
         **timing_keys(devt, [f"mix_cascade flagship mesh 2x1 block {LIVE_BLOCK} "
                              f"shard0/front"])},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def peer_dies_child(argv: list[str]) -> int:
    """``chip_smoke.py --peer-dies COORD PID``: one of the three processes
    of a global 2x3 flagship mesh at 384,000, each holding its own card
    twice (NCCL inside the graphs).  Process 2 leaves after two replays;
    the others step on: their next replay's NCCL kernels wait for it until
    ``multihost.TIMEOUT_S`` (30 s here), the group is aborted and the step
    raises, which ends the process with exit code 1 (``END_GRACE_S``
    later at the latest).  A survivor that steps through prints
    ``stepped``."""
    from sdrreceiver_tpu_torch.dist import ShardedReceiver, multihost

    multihost.TIMEOUT_S = 30
    mesh, plan = proc_mesh(argv[0], int(argv[1]), 2, n_chan=3, n_proc=3)
    rx = ShardedReceiver(plan, mesh, LIVE_BLOCK)
    print(f"exchange {rx.exchange}", flush=True)
    blocks = torch.tensor(plan_stream(plan, 2, LIVE_BLOCK, seed=21), device=mesh.home)
    st = rx.init_state()
    last = time.monotonic()
    try:
        for k in range(2 if mesh.rank == 2 else 8):
            st, _ = rx.step_u8(st, blocks[k % 2])
            last = time.monotonic()
            print(f"replay {k + 1}", flush=True)
    except RuntimeError:
        print(f"raised {time.monotonic() - last:.1f} s after its last replay", flush=True)
        raise
    if mesh.rank == 2:
        print("leaving", flush=True)
        return 0
    print("stepped: a replay finished without its peer", flush=True)
    return 0


def phase_peer_dies(card: str) -> None:
    """21 (three cards or more). A peer that dies mid-run on distinct
    cards: the global 2x3 of three processes, process 2 leaving after two
    replays; the other two must exit 1 within ``TIMEOUT_S`` (30 s) +
    ``END_GRACE_S`` of their last replay, print no result, and say the
    NCCL group was aborted."""
    from sdrreceiver_tpu_torch.dist import multihost

    coord = f"127.0.0.1:{free_port()}"
    t0 = time.perf_counter()
    res = processes([["--peer-dies", coord, i] for i in range(3)], timeout=240,
                    envs=[{"CUDA_VISIBLE_DEVICES": str(i)} for i in range(3)])
    secs = time.perf_counter() - t0
    limit = 30 + multihost.END_GRACE_S
    print(f"a peer that dies mid-run, global 2x3 of three processes a card each (nccl): exit "
          f"codes {[rc for rc, _, _ in res]} after {secs:.1f} s {card}")
    waited = []
    for i, (rc, so, se) in enumerate(res):
        errs = [line[:200] for line in se.splitlines() if "rror" in line][-3:]
        print(f"  process {i}: {so.strip().splitlines()[-2:]} {errs}")
        raised = [line for line in so.splitlines() if line.startswith("raised ")]
        waited += [float(line.split()[1]) for line in raised]
    (rc2, so2, _), survivors = res[2], res[:2]
    if rc2 != 0 or "leaving" not in so2 or "exchange nccl" not in so2:
        fail("the peer that leaves did not step twice through NCCL and leave")
    if any(rc != 1 or "stepped" in so or "NCCL group was aborted" not in se
           for rc, so, se in survivors) or len(waited) != 2 or max(waited) > limit:
        fail(f"a peer gone mid-run did not end both survivors with exit code 1 within "
             f"{limit} s of their last replay (waited {waited})")


def proc_cli_layout(card: str) -> dict:
    """21 (three cards or more). ``process-file --mesh 2x3 --partition
    global --num-processes 3``, each process its own card held twice
    (NCCL): every process exits 0 through graphs and NCCL, launches its
    kernels once a block, writes the topics it owns, and the union is
    within 1 LSB of the one-process ``process-file --mesh 2x3`` on the
    same recording (bit-equality printed).  Process 0's summary."""
    d = WORK / "proc_cli_layout"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    ini = d / "flag.ini"
    ini.write_text(flagship_ini(free_port()))
    raw, _ = flagship_stream(4, LIVE_BLOCK, seed=21)
    raw.tofile(d / "flag.u8")
    coord = f"127.0.0.1:{free_port()}"
    argv = ["process-file", "-s", ini, "--iq", d / "flag.u8", "--device", DEVICE,
            "--block", LIVE_BLOCK, "--mesh", "2x3"]
    t0 = time.perf_counter()
    res = processes([["--cli", *argv, "--out", d / f"p{i}", "--partition", "global",
                      "--coordinator", coord, "--num-processes", 3, "--process-id", i]
                     for i in range(3)], envs=[{"CUDA_VISIBLE_DEVICES": str(i)} for i in range(3)])
    secs = time.perf_counter() - t0
    what = "process-file --mesh 2x3 --partition global --num-processes 3 (a card each)"
    sums, parts = [], []
    for i, (rc, so, se) in enumerate(res):
        if rc:
            fail(f"{what}: process {i} exited {rc}: {se[-2000:]}")
        *_, summary, last = so.strip().splitlines()
        summary, (launches,) = json.loads(summary), json.loads(last)["launches"]
        mh = summary["multihost"]
        parts.append(read_audio(d / f"p{i}"))
        print(f"{what}: process {i} exchange {summary.get('exchange')}, cuda_graphs "
              f"{summary['cuda_graphs']}, launches {launches} over {summary['blocks']} blocks, "
              f"report n_hosts {mh['report']['n_hosts']} n_time {mh['report']['n_time']}, "
              f"topics {sorted(parts[i])} {card}")
        if summary.get("exchange") != "nccl" or not summary["cuda_graphs"] or not launches \
                or any(n != summary["blocks"] for n in launches.values()) \
                or set(parts[i]) != set(mh["local_topics"]) \
                or (mh["report"]["n_hosts"], mh["report"]["n_time"]) != (3, 2):
            fail(f"{what}: process {i} did not run its part through NCCL graphs")
        sums.append(summary)
    union = {k: v for p in parts for k, v in p.items()}
    if sum(map(len, parts)) != len(union):
        fail(f"{what}: a topic written twice")
    cli(*argv, "--out", d / "one")
    one = read_audio(d / "one")
    same = union.keys() == one.keys() and all(np.array_equal(union[k], one[k]) for k in one)
    print(f"{what}: {secs:.1f} s for the three, start-up included; the union of "
          f"{len(union)} topics vs the one-process --mesh 2x3 bit-equal: {same} {card}")
    audio_diff(union, one, f"{what} union vs the one-process 2x3")
    return sums[0]["multihost"]


def procs_any_layout(card: str) -> None:
    """21 (three cards or more). Global meshes whose processes' devices end
    one time row and begin the next, each process its own card held
    several times (NCCL inside the graphs): the flagship global 2x3 of
    three processes at 1,536,000 and 384,000 and cband66's at 384,000, the
    flagship global 3x2 of two processes at 384,000; then the CLI's 2x3
    and a peer that dies mid-run."""
    flag = phase_proc_graphs(card, n_local=2, distinct=True, n_cards=1, n_chan=3, n_proc=3)
    cband = phase_proc_graphs(card, n_local=2, distinct=True, n_cards=1, n_chan=3, n_proc=3,
                              plan="cband", blocks=(LIVE_BLOCK,))
    three = phase_proc_graphs(card, n_local=3, distinct=True, n_cards=1, n_chan=2, n_proc=2,
                              blocks=(LIVE_BLOCK,))
    for name, procs in (("flagship global 2x3", flag), ("cband66 global 2x3", cband),
                        ("flagship global 3x2", three)):
        for k, c in enumerate(procs[0]["cases"]):
            cs = [p["cases"][k] for p in procs]
            print(f"{name} block {c['block']} (NCCL graphs, per process, each in its own "
                  f"turns): step ms {[round(x['ms']['graph'], 4) for x in cs]}, eager "
                  f"{[round(x['ms']['eager'], 4) for x in cs]}, gloo graphs "
                  f"{[round(x['ms']['gloo'], 4) for x in cs]}; device us "
                  f"{[round(x['device_us']['graph'], 1) for x in cs]}, idle share "
                  f"{[round(x['idle']['graph'], 4) for x in cs]}, peak MiB "
                  f"{[round(x['mem']['graph'], 1) for x in cs]}, NCCL rows a replay "
                  f"{[x['kinds']['graph']['nccl'] for x in cs]}, graphs a replay "
                  f"{[x['graphs'] for x in cs]}; one-process mesh "
                  f"{procs[0]['union_ms'][c['block']]['mesh']:.4f} ms, one device "
                  f"{procs[0]['union_ms'][c['block']]['one']:.4f} ms {card}")
    proc_cli_layout(card)
    phase_peer_dies(card)


def cards_header(n: int) -> tuple[list[str], str]:
    """Fails unless there are ``n`` CUDA devices; the ``nvidia-smi`` lines
    (name, power limit) of the cards, and a tag for the printed lines."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        fail(f"this mode needs {n} CUDA devices")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    print("\n".join(smi))
    from sdrreceiver_tpu_torch.cuda import build

    build.library()
    return smi, f"[{smi[0]} x{len(smi)}]"


def procs_on_cards(card: str) -> None:
    """Phase 21's paths across processes that need distinct cards, every
    one exchanging through NCCL inside the graphs: the global 2x1 with a
    card a process; the global 1x2 (a time row across two processes, each
    computing its own channel ranges) of the flagship at 1,536,000 and
    384,000 and of the 66-channel plan at 384,000, with the one-process 1x2
    over the same cards and one device timed beside it; where there are
    four cards, the global 4x1 with two cards a process and the flagship's
    global 2x2 of four processes (rows and columns both across
    processes); ``bench`` and ``run`` on the global 1x2
    (:func:`proc_cli_cards`); the capture failure in one of two
    processes on distinct cards; and with three cards or more the layouts
    whose processes end one time row and begin the next
    (:func:`procs_any_layout`)."""
    two = phase_proc_graphs(card, n_local=1, distinct=True)
    row = phase_proc_graphs(card, distinct=True, n_chan=2)
    phase_proc_graphs(card, distinct=True, n_chan=2, plan="cband", blocks=(LIVE_BLOCK,))
    for k, block in enumerate((BLOCK, LIVE_BLOCK)):
        ms = {name: [p["cases"][k]["ms"]["graph"] for p in procs]
              for name, procs in (("global 1x2", row), ("global 2x1", two))}
        print(f"flagship block {block}, step ms (NCCL graphs, per process; measured in each "
              f"process's own turns): global 1x2 {ms['global 1x2']} / global 2x1 "
              f"{ms['global 2x1']} / one-process 1x2 {row[0]['union_ms'][block]['mesh']:.4f} / "
              f"one device {row[0]['union_ms'][block]['one']:.4f}; device us per process "
              f"{[p['cases'][k]['device_us']['graph'] for p in row]} (1x2), idle share "
              f"{[round(p['cases'][k]['idle']['graph'], 4) for p in row]} (1x2) {card}")
    if torch.cuda.device_count() >= 4:
        phase_proc_graphs(card, n_local=2, distinct=True)
        phase_proc_graphs(card, distinct=True, n_chan=2, n_proc=4)
    proc_cli_cards(card)
    phase_capture_failure_procs(card, distinct=True)
    if torch.cuda.device_count() >= 3:
        procs_any_layout(card)


def last_lines(smi: list[str]) -> None:
    print(smi[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def four_cards() -> None:
    """``chip_smoke.py --four-cards``: on a machine of four cards, only the
    paths that need them: phase 20's meshes over four distinct cards and
    :func:`procs_on_cards` (``chip_smoke.py --procs-on-cards`` alone, on a
    machine of two cards or more)."""
    smi, card = cards_header(4)
    phase_mesh_graphs(torch.device(DEVICE), card, 20, layouts=mesh_layouts(torch.device(DEVICE))[1:])
    procs_on_cards(card)
    last_lines(smi)


def tracer_hold() -> None:
    """``chip_smoke.py --tracer``: the flagship at 384,000-sample blocks,
    400 blocks with the tracer on, every output fetched, then 400 more with
    a callback that holds the host 1 ms a block (a spin: ``time.sleep``
    oversleeps by a varying share of a millisecond).  The timeline's idle
    share rises to within 5 points of 1 - d / (h + 1 ms), d and h a block's
    event-timed device time (H2D + step + D2H) and host time without the
    hold; the fetch wait falls to the host's own part; most idle time is
    named ``runtime.deliver``; the profiler sees no CUDA row from the
    timing events.  The first 10 blocks of each run are not read."""
    from sdrreceiver_tpu_torch.core.runtime import run_pipeline
    from sdrreceiver_tpu_torch.flagship import benchmark_config
    from sdrreceiver_tpu_torch.graph.compiler import CompiledReceiver
    from sdrreceiver_tpu_torch.graph.plan import build_plan
    from sdrreceiver_tpu_torch.obs import trace

    smi, card = cards_header(1)
    rx = CompiledReceiver(build_plan(benchmark_config()), LIVE_BLOCK, device=torch.device(DEVICE))
    pool = np.random.default_rng(2**31 + 5).integers(96, 160, size=(16, 2 * LIVE_BLOCK),
                                                      dtype=np.uint8)
    _, state = run_pipeline(rx, iter(pool[:8]), lambda o: 0, raw_u8=True, return_state=True)
    n, read = 400, set(range(10, 400))

    def traced(hold_ns: int):
        nonlocal state

        def sink(outs):
            end = time.monotonic_ns() + hold_ns
            while time.monotonic_ns() < end:
                pass
            return 0

        trace.enable()
        metrics, state = run_pipeline(rx, (pool[i % 16] for i in range(n)), sink, raw_u8=True,
                                      state=state, return_state=True)
        torch.cuda.synchronize()
        rec = trace.snapshot()
        trace.disable()
        wait = float(np.median(trace.durations_ns(rec, "runtime.fetch_wait", read))) / 1e6
        return rec, float(np.median(metrics.block_seconds[10:])) * 1e3, wait

    base, h, wait0 = traced(0)
    held, h1, wait1 = traced(1_000_000)
    d = float(np.median(trace.device_intervals(base, read)["busy"])) / 1e6
    before, got = 100 * trace.idle_share(base, read), 100 * trace.idle_share(held, read)
    want = 100 * (1 - d / (h + 1.0))
    idle = trace.summarize(held)["idle_s_by_span"]
    print(f"tracer, 1 ms hold a block at {LIVE_BLOCK}: d {d:.4f} ms, h {h:.4f} ms "
          f"(held {h1:.4f}); event idle share {before:.2f} -> {got:.2f} %, "
          f"1 - d/(h + 1 ms) {want:.2f} %; fetch wait {wait0:.4f} -> {wait1:.4f} ms; "
          f"idle s by span {idle} {card}")
    if not got > before + 30 or not abs(got - want) <= 5.0:
        fail("tracer: the held run's idle share is not 1 - d/(h + 1 ms) within 5 points")
    # the device is done before the host asks: what is left is the host's
    # own event wait and numpy views
    if not wait1 < 0.1:
        fail("tracer: the held run still waits for its D2H copies")
    if max(idle, key=idle.get) != "runtime.deliver" \
            or not idle["runtime.deliver"] > 0.5 * sum(idle.values()):
        fail("tracer: the held run's idle time is not named runtime.deliver")

    def rows(on: bool) -> set:
        if on:
            trace.enable()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            run_pipeline(rx, (pool[i % 16] for i in range(20)), lambda o: 0, raw_u8=True,
                         state=state)
            torch.cuda.synchronize()
        trace.disable()
        return {e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA}

    plain, on = rows(False), rows(True)
    print(f"tracer: profiler rows {len(plain)} off, {len(on)} on; new on {sorted(on - plain)} "
          f"{card}")
    if not on <= plain:
        fail(f"tracer: the timing events add profiler rows {sorted(on - plain)}")
    last_lines(smi)


if __name__ == "__main__":
    modes = {"--procgraphs": proc_graphs_child,
             "--capture-failure-procs": capture_failure_procs_child,
             "--peer-dies": peer_dies_child}
    if os.environ.get("SMOKE_DUMP_S"):  # a child of processes(): its stacks before a kill
        import faulthandler

        faulthandler.dump_traceback_later(float(os.environ["SMOKE_DUMP_S"]), exit=False)
    if sys.argv[1:2] == ["--cli"]:
        sys.exit(cli_child(sys.argv[2:]))
    if sys.argv[1:2] and sys.argv[1] in modes:
        # a mesh child ends here without the interpreter's teardown: it has
        # left its process group, and what torch still holds can only delay it
        try:
            rc = modes[sys.argv[1]](sys.argv[2:])
        except SystemExit as e:
            rc = e.code if isinstance(e.code, int) else 1
        except BaseException:
            import traceback

            traceback.print_exc()
            rc = 1
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(rc)
    if sys.argv[1:2] == ["--capture-failure"]:
        sys.exit(capture_failure_child())
    if sys.argv[1:2] == ["--tracer"]:
        tracer_hold()
        sys.exit(0)
    if sys.argv[1:2] == ["--four-cards"]:
        four_cards()
        sys.exit(0)
    if sys.argv[1:2] == ["--procs-on-cards"]:
        smi, card = cards_header(2)
        procs_on_cards(card)
        last_lines(smi)
        sys.exit(0)
    main()
