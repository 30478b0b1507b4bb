"""Command-line entry points of the PyTorch port.

    python -m sdrreceiver_tpu_torch run -s rx.ini --device cuda
    python -m sdrreceiver_tpu_torch process-file -s rx.ini --iq rec.u8 --out DIR --device cuda

Port of ``sdrreceiver_tpu.cli.main``, with its flags, output files and
JSON:

  run           live receive -> ZMQ egress, like the reference app: raw u8
                IQ from an rtl_tcp server (``remote_rtl`` in the ini), from
                an IQ recording looped at the dongle's pace (``--iq``), or
                from a local librtlsdr USB device; optional UDP control
                socket and switchable live scope
  devices       list attached RTL USB devices (index, name, serial)
  process-file  offline: IQ recording in, per-channel audio files out
                (and/or ZMQ egress, a spectrum, a state checkpoint)
  synth         generate a synthetic USB-channel IQ recording
  plan          print the compiled channelizer plan for an ini (JSON)
  bench         steady-state throughput of the receiver on synthetic blocks

``--device`` picks the torch device (default ``cuda``; asking for it
without a card is an error, never a fall back to the CPU).  On the card the
receiver replays one CUDA graph per step, and a mesh one graph per phase
and card where it spans processes too (the receivers' default): its
exchanges NCCL collectives inside the graphs where every process holds
cards of its own, else gloo calls between the phases.  ``--plain`` runs the
kernels' plain PyTorch versions, eagerly (``use_kernels=False,
cuda_graphs=False``).  Each command's JSON summary says whether graphs ran
(``"cuda_graphs"``) and, under ``--partition global``, which library
exchanged (``"exchange"``: ``"nccl"`` or ``"gloo"``).
``run`` and ``process-file`` take ``--trace-out FILE``: the command runs
with the in-program tracer on (``obs.trace``), writes its record to FILE as
Chrome trace-event JSON (Perfetto opens it) and adds per-span medians to
its JSON summary (``"trace"``).
``--mesh TxC`` runs the sharded receiver over T*C local devices (the cards,
repeated when T*C exceeds their count; ``--device cpu``: the CPU T*C
times).  ``--coordinator HOST:PORT`` with ``--num-processes`` and
``--process-id`` joins a gloo process group: each process runs the groups
assigned to it (``--partition groups``), or its time shards of ONE mesh
over every process's devices (``--partition global``, where ``--mesh`` is
the global shape).
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import pathlib
import sys
import threading
import time

import numpy as np


def _mesh_shape(arg: str, what: str) -> tuple[int, int]:
    try:
        n_time, n_chan = (int(v) for v in arg.lower().split("x"))
    except ValueError:
        n_time = n_chan = 0
    if n_time < 1 or n_chan < 1:
        raise SystemExit(f"--mesh wants TxC{what}, got {arg!r}")
    return n_time, n_chan


def _all_taps(plan) -> tuple[str, ...]:
    return ("main", *(f"g{g.index}" for g in plan.groups),
            *(s.topic for g in plan.groups for b in g.buckets for s in b.subs))


def _build(args, taps=()):
    """(config, plan, receiver) for a command; ``SystemExit`` for a device
    the port cannot use or an option it cannot honour.  ``taps="all"``
    compiles every scope tap into the step (the live scope picks one at run
    time).

    With ``--coordinator`` this process joins the gloo process group:
    under ``--partition global`` it runs the FULL plan over one mesh over
    every process's devices and publishes the groups it owns; otherwise the
    plan is cut to the groups assigned to this process.  ``args._multihost``
    then carries the assignment for the command's summary."""
    import torch

    from ..graph.compiler import CompiledReceiver
    from ..graph.config import load_ini
    from ..graph.plan import build_plan

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"error: --device {args.device} requested but CUDA is not available")
    cfg = load_ini(args.settings)
    plan = build_plan(cfg, strict_reference=args.strict_reference)
    full_taps = set(_all_taps(plan))
    args._full_taps, args._full_plan = full_taps, plan
    args._multihost = args._egress_owner = None
    # on the card the kernel path replays CUDA graphs; the plain one is eager
    kw = {"use_kernels": not args.plain, "cuda_graphs": not args.plain}
    if args.coordinator and args.partition == "global":
        # one mesh over every process's devices: compute splits evenly,
        # the halos and the output gather cross processes, egress stays
        # per process by a deterministic group -> process map
        from ..dist import ShardedReceiver, local_devices, multihost

        pid, n = multihost.initialize(args.coordinator, args.num_processes, args.process_id)
        n_time, n_chan = _mesh_shape(args.mesh, "") if args.mesh else (None, 1)
        n_local = None  # every local card
        if args.mesh:
            if (n_time * n_chan) % n:
                raise SystemExit(f"--mesh {args.mesh} is the GLOBAL shape under "
                                 f"--partition global; {n} processes")
            n_local = n_time * n_chan // n
        mesh = multihost.global_mesh(n_chan=n_chan, devices=local_devices(n_local, args.device))
        own = multihost.egress_owner(plan, n)
        args._egress_owner = multihost.output_key_owner(plan, n)
        args._multihost = {
            "mode": "global",
            "process_id": pid,
            "num_processes": n,
            "coordinator": args.coordinator,
            "egress_owner": {int(k): int(v) for k, v in own.items()},
            "local_topics": [s.topic for g in plan.groups if own[g.index] == pid
                             for b in g.buckets for s in b.subs],
            "report": multihost.global_report(plan, n, mesh.shape["time"]),
        }
        div = plan.block_divisor() * mesh.shape["time"]
        block = args.block or -(-plan.block_samples // div) * div
        taps = _all_taps(plan) if taps == "all" else taps
        return cfg, plan, ShardedReceiver(plan, mesh, block, emit_taps=tuple(taps), **kw)
    if args.coordinator:
        from ..dist import multihost

        plan, args._multihost = multihost.distributed_subplan(
            plan, args.coordinator, args.num_processes, args.process_id
        )
        if not plan.groups:
            raise SystemExit(
                f"process {args._multihost['process_id']} was assigned no groups "
                f"({args._multihost['num_processes']} processes > "
                f"{len(args._multihost['assignment'])} groups)"
            )
    if taps == "all":
        taps = _all_taps(plan)
    elif taps and args._multihost:
        # a fleet started with one shared command line may name a tap that
        # another process owns: drop it here, with a note; a tap the FULL
        # plan does not know still fails
        local = set(_all_taps(plan))
        dropped = [t for t in taps if t not in local and t in full_taps]
        if dropped:
            print(f"process {args._multihost['process_id']}: taps {dropped} belong to "
                  f"other hosts' groups; dropping locally", file=sys.stderr)
            taps = tuple(t for t in taps if t not in dropped)
    if args.mesh:
        from ..dist import ShardedReceiver, local_devices, make_mesh

        n_time, n_chan = _mesh_shape(args.mesh, " (e.g. 4x2)")
        mesh = make_mesh(n_time, n_chan, local_devices(n_time * n_chan, args.device))
        # default block: the smallest multiple of the sharded divisor that
        # is at least the reference's buffer
        div = plan.block_divisor() * n_time
        block = args.block or -(-plan.block_samples // div) * div
        return cfg, plan, ShardedReceiver(plan, mesh, block, emit_taps=tuple(taps), **kw)
    return cfg, plan, CompiledReceiver(
        plan, args.block, emit_taps=tuple(taps), device=args.device, **kw
    )


def _egress_filter(args):
    """Global mode: every process holds every output, but fetches and
    publishes only the groups it owns (and any scope tap), so each topic
    has one publisher.  None otherwise."""
    if args._egress_owner is None:
        return None
    from ..dist.multihost import key_owner

    pid, owner = args._multihost["process_id"], args._egress_owner

    def keep(k: str) -> bool:
        if k.startswith("tap/"):
            return True
        h = key_owner(owner, k)
        return h is None or h == pid

    return keep


def cmd_plan(args) -> int:
    from ..graph.config import load_ini
    from ..graph.plan import build_plan
    from ..obs.metrics import plan_cost_model

    plan = build_plan(load_ini(args.settings), strict_reference=args.strict_reference)
    info = {
        "fs": plan.fs,
        "center_frequency": plan.center_frequency,
        "dc_correct": plan.dc_correct,
        "bufsplit": plan.bufsplit,
        "block_samples": plan.block_samples,
        "block_divisor": plan.block_divisor(),
        "num_channels": plan.num_channels(),
        "groups": [
            {
                "index": g.index,
                "direct": g.direct,
                "mixer_freq": g.mixer_freq,
                "out_rate": g.out_rate,
                "stages": g.stages,
                "publishes_iq": g.publishes_iq,
                "buckets": [
                    {
                        "stages": b.stages,
                        "late_factor": b.late_factor,
                        "out_rate": b.out_rate,
                        "channels": b.channels,
                        "topics": [s.topic for s in b.subs],
                    }
                    for b in g.buckets
                ],
            }
            for g in plan.groups
        ],
        "cost_model": plan_cost_model(plan),
    }
    print(json.dumps(info, indent=2))
    return 0


def cmd_synth(args) -> int:
    from ..graph.config import load_ini
    from ..graph.plan import build_plan
    from ..io import iqfile

    plan = build_plan(load_ini(args.settings))
    only = set(args.only.split(",")) if args.only else None
    chans = []
    tone_map = {}
    subs = [s for g in plan.groups for b in g.buckets for s in b.subs]
    for i, s in enumerate(subs):
        if only is not None and s.topic not in only:
            continue
        tone = args.tone + 37.0 * i  # distinct tone per channel
        chans.append((s.frequency, tone, args.amplitude))
        tone_map[s.topic] = tone
    iq = iqfile.synthesize_channels(
        int(args.seconds * plan.fs), plan.fs, plan.center_frequency, chans,
        noise=args.noise, dc_offset=args.dc + 0j,
    )
    iqfile.write_iq(args.out, iq, args.format)
    print(json.dumps({
        "out": args.out, "format": args.format, "samples": len(iq),
        "channels": len(chans), "tones": tone_map,
    }))
    return 0


def _write_png(path: pathlib.Path, curve: np.ndarray, fs_tap: int, tap: str) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    freqs = (np.arange(len(curve)) - len(curve) / 2) * fs_tap / 8192
    fig, ax = plt.subplots(figsize=(10, 4))
    ax.plot(freqs / 1e3, curve, lw=0.7)
    ax.set_xlabel("offset from center [kHz]")
    ax.set_ylabel("power [dB]")
    ax.set_title(f"spectrum: {tap}")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def _trace_out(args, summary: dict) -> None:
    """``--trace-out FILE``: the record as Chrome trace JSON in FILE, its
    per-span medians under the summary's ``"trace"``; tracing ends."""
    if args.trace_out:
        from ..obs import trace

        rec = trace.snapshot()
        trace.disable()
        trace.write_chrome(args.trace_out, rec)
        summary["trace"] = trace.summarize(rec)


def cmd_process_file(args) -> int:
    from ..core import checkpoint
    from ..core.runtime import run_pipeline
    from ..io import iqfile, zmqpub
    from ..obs.spectrum import SpectrumEMA

    _, plan, rx = _build(args, taps=(args.spectrum,) if args.spectrum else ())
    if args.spectrum and args.spectrum not in rx.tap_rates():
        args.spectrum = None  # dropped by _build: another process owns it
    fetch_filter = _egress_filter(args)
    if fetch_filter is not None and args.burst > 1:
        raise SystemExit("--burst > 1 is not supported with --partition global")
    iq = iqfile.read_iq(args.iq, args.format)
    outdir = pathlib.Path(args.out) if args.out else None
    if outdir:
        outdir.mkdir(parents=True, exist_ok=True)

    hub = zmqpub.EgressHub(plan) if args.zmq else None
    sink: dict[str, list[np.ndarray]] = {}
    spectrum = SpectrumEMA() if args.spectrum else None
    spec_count = [0]

    def on_outputs(outs: dict[str, np.ndarray]) -> int:
        sent = hub.publish_outputs(outs) if hub else 0
        for k, v in outs.items():
            if k.startswith("tap/"):
                # the reference strides its display FFT by 5 buffers
                # (sdrj.cpp:296-303); same cadence here
                if spectrum is not None and spec_count[0] % 5 == 0:
                    spectrum.update(v)
                spec_count[0] += 1
            elif outdir is not None:
                sink.setdefault(k, []).append(v)
        return sent

    state = None
    if args.resume:
        state = rx.import_state(checkpoint.load_state(args.resume, plan))
    # interleaved f32 pairs, as the JAX package's CLI feeds them
    blocks = (b.view(np.float32) for b in iqfile.iter_blocks(iq, rx.block))

    def run():
        return run_pipeline(
            rx, blocks, on_outputs, max_blocks=args.max_blocks, state=state,
            return_state=True, burst=args.burst, fetch_filter=fetch_filter,
        )

    if args.profile:
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if rx.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            metrics, final_state = run()
        pathlib.Path(args.profile).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(pathlib.Path(args.profile) / "trace.json"))
        print(f"profiler trace written to {args.profile}", file=sys.stderr)
    else:
        metrics, final_state = run()

    written = []
    if outdir is not None:
        rates = rx.rates()
        for k, parts in sink.items():
            data = np.concatenate(parts)
            name = k.replace("/", "_") + (".s16" if k.startswith("audio") else ".bin")
            data.tofile(outdir / name)
            written.append(name)
            if args.wav and k.startswith("audio/"):
                from ..io.wavout import write_wav

                wname = k.replace("/", "_") + ".wav"
                write_wav(outdir / wname, data, rates[k])
                written.append(wname)
        if spectrum is not None:
            name = f"spectrum_{args.spectrum}.npy"
            np.save(outdir / name, spectrum.smoothed)
            written.append(name)
            if args.spectrum_png:
                pname = f"spectrum_{args.spectrum}.png"
                try:
                    _write_png(outdir / pname, spectrum.smoothed,
                               rx.tap_rates()[args.spectrum], args.spectrum)
                    written.append(pname)
                except ImportError as e:
                    print(f"spectrum png failed: {e}", file=sys.stderr)
    if args.save_state:
        checkpoint.save_state(args.save_state, rx.export_state(final_state), plan)
    if hub:
        hub.close()

    out = metrics.summary()
    out["device"] = str(rx.device)
    out["cuda_graphs"] = rx._graphs is not None
    if getattr(rx, "exchange", None):
        out["exchange"] = rx.exchange
    if args._multihost:
        out["multihost"] = args._multihost
    out["outputs_written"] = sorted(written)
    out["realtime_factor"] = round(metrics.samples_per_second / plan.fs, 2)
    _trace_out(args, out)
    print(json.dumps(out))
    return 0


def _rtl_tcp_source(client, rx, stack: contextlib.ExitStack):
    """u8 blocks from an rtl_tcp client, whether the next one is waiting
    (``run_pipeline``'s ``source_ready``) and a summary hook.  With the
    native library, a reader thread pushes whole blocks into the 20-slot
    ring that the pipeline pops (the reference's ring, jonti/sdr.cpp:100-184;
    a full ring drops the block); without it the pipeline reads the socket
    and there is no readiness to ask."""
    from ..io import native

    n_bytes = 2 * rx.block
    if not native.available():
        return client.iter_blocks(n_bytes), None, lambda: {"rtl_tcp": dict(client.stats)}
    ring = native.IngestRing(block_bytes=n_bytes, n_slots=20)

    def reader():
        try:
            for b in client.iter_blocks(n_bytes):
                if ring.push(b) < 0:  # closed
                    return
        except OSError as e:
            if not client.closed:
                print(f"rtl_tcp reader stopped: {e}", file=sys.stderr)
        finally:
            ring.close()

    thread = threading.Thread(target=reader, name="rtl_tcp reader", daemon=True)
    thread.start()

    def stop():
        client.close()  # wakes the reader
        ring.close()
        thread.join(timeout=10.0)

    stack.callback(stop)

    def blocks():
        while (b := ring.pop_raw(timeout_ms=5000)) is not None:
            yield b

    return (blocks(), lambda: ring.depth() > 0,
            lambda: {"ring": ring.stats, "rtl_tcp": dict(client.stats)})


def _usb_blocks(dev):
    """u8 blocks from a local device's ring.  A silent ring (stalled async
    read, unplugged dongle) restarts the device with backoff, up to 5 times
    in a row, before the stream ends (the reference needs a manual restart,
    sdrj.cpp:107-123)."""
    retries = 0
    while True:
        b = dev.ring.pop_raw(timeout_ms=5000)
        if b is not None:
            retries = 0
            yield b
            continue
        if retries >= 5:
            print("usb stream lost; giving up after 5 restart attempts", file=sys.stderr)
            return
        retries += 1
        print(f"usb stream silent; restart attempt {retries}", file=sys.stderr)
        if not dev.restart():
            time.sleep(min(2.0 * retries, 8.0))


def cmd_run(args) -> int:
    from ..core.runtime import run_pipeline
    from ..io import iqfile, rtltcp, rtlusb, zmqpub
    from .control import ControlServer

    cfg, plan, rx = _build(args, taps="all" if args.scope is not None else ())
    ctrl_cmds: dict = {}
    fetch_filter = egress = _egress_filter(args)
    scope = None
    if args.scope is not None:
        from ..obs.spectrum import LiveScope

        initial = args.scope
        if args._multihost and initial not in rx.tap_rates() and initial in args._full_taps:
            # valid, but another process owns it: start on main instead of
            # taking this process (and the fleet) down
            print(f"process {args._multihost['process_id']}: scope tap {initial!r} belongs "
                  f"to another host; starting on 'main'", file=sys.stderr)
            initial = "main"
        # the reference's runtime-switchable spectrum (fftVFOSlot)
        scope = LiveScope(rx.tap_rates(), initial=initial)
        if scope.active is None:
            print(f"unknown scope tap {initial!r}; valid: {sorted(rx.tap_rates())}",
                  file=sys.stderr)
            return 2
        fetch_filter = scope.wants if egress is None else (
            lambda k, _w=scope.wants: _w(k) and egress(k))
        ctrl_cmds = {"set_scope": scope.set_scope, "set_fft": scope.set_fft,
                     "spectrum": scope.snapshot}

    with contextlib.ExitStack() as stack:
        hub = zmqpub.EgressHub(plan)
        stack.callback(hub.close)

        def publish(outs: dict) -> int:
            if scope is not None:
                scope.observe(outs)
            return hub.publish_outputs(outs)

        tuner = stats_fn = source_ready = None
        realtime_fs = None
        source_stats = dict  # the summary keys a source adds
        if cfg.remote_rtl and not args.iq:
            # elastic client: a lost stream reconnects with backoff and
            # replays the configure sequence and the last retune (the
            # reference stays alive but needs a manual restart,
            # sdrj.cpp:107-123)
            client = tuner = rtltcp.ElasticRtlTcp(cfg.remote_rtl)
            stack.callback(client.close)
            print(f"rtl_tcp connected: tuner type {client.greeting.tuner_type}, "
                  f"{client.greeting.tuner_gain_count} gains", file=sys.stderr)
            client.configure(plan.fs, plan.center_frequency, cfg.remote_rtl_gain_idx, agc=False)
            blocks, source_ready, source_stats = _rtl_tcp_source(client, rx, stack)
        elif args.iq:
            iq = iqfile.read_iq(args.iq, args.format)
            looped = itertools.chain.from_iterable(
                iqfile.iter_blocks(iq, rx.block) for _ in itertools.count()
            )
            # interleaved f32 pairs, as the JAX package's CLI feeds them
            blocks = (b.view(np.float32) for b in looped)
            realtime_fs = None if args.fast else plan.fs
        else:
            if not rtlusb.available():
                print("no source: set remote_rtl in the ini (rtl_tcp), pass --iq FILE, "
                      "or install librtlsdr for local USB devices", file=sys.stderr)
                return 2
            # device pick by serial, then index, like the reference's
            # auto_start (mainwindow.cpp:290-350, sdrj.cpp:306-311)
            idx = cfg.auto_start_tuner_idx
            if cfg.auto_start_tuner_serial:
                idx = rtlusb.index_by_serial(cfg.auto_start_tuner_serial)
                if idx < 0:
                    print(f"no device with serial {cfg.auto_start_tuner_serial!r}",
                          file=sys.stderr)
                    return 2
            dev = tuner = rtlusb.RtlUsbDevice(idx)
            stack.callback(dev.close)
            dev.start(plan.fs, plan.center_frequency, 2 * rx.block, cfg.tuner_gain)
            if cfg.auto_start_biast:
                dev.set_bias_tee(True)
            print(f"rtlsdr device {idx} streaming: fs={plan.fs}, "
                  f"center={plan.center_frequency}, gain={cfg.tuner_gain}", file=sys.stderr)
            stats_fn = lambda: dict(dev.ring.stats)  # noqa: E731
            blocks = _usb_blocks(dev)
            source_ready = lambda: dev.ring.depth() > 0  # noqa: E731
            source_stats = lambda: {  # noqa: E731
                "ring": dev.ring.stats, "usb_restarts": dev.restarts}
        if args.control_port is not None:
            ctrl = ControlServer(args.control_port, rtl_client=tuner, stats_fn=stats_fn,
                                 commands=ctrl_cmds)
            stack.callback(ctrl.close)
            print(f"control socket on udp:{ctrl.port}", file=sys.stderr)
        metrics = run_pipeline(
            rx, blocks, publish, raw_u8=tuner is not None, max_blocks=args.max_blocks,
            realtime_fs=realtime_fs, fetch_filter=fetch_filter, source_ready=source_ready,
        )
        summary = metrics.summary()
        summary.update(source_stats())
    summary["device"] = str(rx.device)
    summary["cuda_graphs"] = rx._graphs is not None
    if getattr(rx, "exchange", None):
        summary["exchange"] = rx.exchange
    if args._multihost:
        summary["multihost"] = args._multihost
    _trace_out(args, summary)
    print(json.dumps(summary))
    return 0


def cmd_devices(args) -> int:
    """List attached RTL USB devices (the reference's sdr::deviceNames,
    jonti/sdr.cpp:248-273)."""
    from ..io import rtlusb

    if not rtlusb.available():
        print("librtlsdr not found", file=sys.stderr)
        return 2
    for d in rtlusb.enumerate_devices():
        print(json.dumps({"index": d.index, "name": d.name, "manufacturer": d.manufacturer,
                          "product": d.product, "serial": d.serial}))
    return 0


def _bench_sps(rx, n_blocks: int) -> float:
    """Steady-state samples/s of ``rx`` over ``n_blocks`` synthetic u8
    blocks (the dongle's wire format) already on the device, through
    ``run_pipeline`` with nothing fetched.  One step first builds the
    kernels and warms the allocator; the clock runs from there to a device
    synchronize after the last step."""
    import torch

    from ..core.runtime import run_pipeline

    rng = np.random.default_rng(0)
    xb = torch.tensor(rng.integers(0, 256, 2 * rx.block, dtype=np.uint8), device=rx.device)

    def sync():
        if rx.device.type == "cuda":
            torch.cuda.synchronize(rx.device)

    state, _ = rx.step_u8(rx.init_state(), xb)
    sync()
    t0 = time.perf_counter()
    run_pipeline(rx, itertools.repeat(xb, n_blocks), raw_u8=True, state=state)
    sync()
    return rx.block * n_blocks / (time.perf_counter() - t0)


def cmd_bench(args) -> int:
    import torch

    from ..graph.compiler import CompiledReceiver
    from ..obs.metrics import plan_cost_model

    _, plan, rx = _build(args)
    sps = _bench_sps(rx, args.blocks)
    device = str(rx.device)
    if rx.device.type == "cuda":
        device += f" ({torch.cuda.get_device_name(rx.device)})"
    out = {
        "device": device,
        "block_samples": rx.block,
        "blocks": args.blocks,
        "mode": "sharded" if args.mesh else ("kernels" if rx.use_kernels else "plain"),
        "cuda_graphs": rx._graphs is not None,
        **({"exchange": rx.exchange} if getattr(rx, "exchange", None) else {}),
        "msamples_per_second": round(sps / 1e6, 2),
        "realtime_factor": round(sps / plan.fs, 1),
        "cost_model": plan_cost_model(plan, rx.block),
    }
    if args._multihost:
        out["multihost"] = mh = args._multihost
        # eff(N) = min_h(sps_h) / (N sps_1): every process also benches the
        # FULL plan on one device (sps_1), then the rates are all-gathered
        full_rx = CompiledReceiver(args._full_plan, device=rx.device, use_kernels=rx.use_kernels,
                                   cuda_graphs=rx.use_kernels)
        sps_1 = _bench_sps(full_rx, max(2, args.blocks // 2))
        mh["sps_1_full_plan"] = round(sps_1 / 1e6, 2)
        import torch.distributed as dist

        parts = [torch.zeros(2, dtype=torch.float64) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, torch.tensor([sps, sps_1], dtype=torch.float64))
        all_sps, all_sps1 = torch.stack(parts).numpy().T
        # the slowest process sets the fleet's rate; sps_1 takes the fleet
        # maximum (processes sharing a host depress each other's probe)
        mh["sps_per_host_msps"] = [round(v / 1e6, 2) for v in all_sps.tolist()]
        mh["eff"] = round(float(all_sps.min() / (len(all_sps) * all_sps1.max())), 4)
        mh["eff_ceiling"] = mh.get("balance_efficiency", mh.get("report", {}).get(
            "balance_efficiency"))
    print(json.dumps(out))
    return 0


def _common(sp, iq_required: bool = False) -> None:
    """The options of every command that builds a receiver (the JAX CLI's
    ``common``, with ``--device``/``--plain`` for its ``--backend``/``--pallas``)."""
    sp.add_argument("-s", "--settings", required=True, help="ini file")
    sp.add_argument("--device", default="cuda", help="torch device (cuda, cuda:N or cpu)")
    sp.add_argument(
        "--plain", action="store_true",
        help="run the kernels' plain PyTorch versions instead of the CUDA kernels",
    )
    sp.add_argument("--block", type=int, default=None, help="ingest block samples")
    sp.add_argument("--max-blocks", type=int, default=None)
    sp.add_argument("--format", default="u8", choices=["u8", "cf32"])
    sp.add_argument(
        "--strict-reference", action="store_true",
        help="reproduce the reference's handling of sub VFOs that match no "
        "main VFO (misprocessed through main group 0, mainwindow.cpp:225)",
    )
    sp.add_argument(
        "--mesh", default=None, metavar="TxC",
        help="run sharded over a (time x chan) mesh of T*C local devices, e.g. 4x2 (the "
        "cards, repeated when T*C exceeds their count; with --partition global, the "
        "GLOBAL shape over every process's devices)",
    )
    sp.add_argument(
        "--coordinator", default=None, metavar="HOST:PORT",
        help="multi-process mode: join the gloo process group at this address; each "
        "process runs the main-VFO groups assigned to it and owns its own ZMQ egress",
    )
    sp.add_argument("--num-processes", type=int, default=None,
                    help="total process count for --coordinator (else WORLD_SIZE)")
    sp.add_argument("--process-id", type=int, default=None,
                    help="this process's id for --coordinator (else RANK)")
    sp.add_argument(
        "--partition", default="groups", choices=["groups", "global"],
        help="multi-process partitioning: 'groups' = whole main-VFO groups per process "
        "(nothing per sample crosses processes), 'global' = ONE (time x chan) mesh over "
        "every process's devices (even compute; halos and the output gather cross "
        "processes); each process publishes the topics of the groups it owns",
    )
    sp.add_argument("--iq", required=iq_required, default=None, help="IQ recording path")


def _trace_arg(sp) -> None:
    sp.add_argument(
        "--trace-out", default=None, metavar="FILE",
        help="trace the run in-program (spans, counters, the card's CUDA-event timeline) "
        "and write it to FILE as Chrome trace-event JSON; adds per-span medians to the summary",
    )


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sdrreceiver-tpu-torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = p.add_subparsers(dest="command", required=True)

    sp = sub.add_parser("plan", help="print the compiled channelizer plan")
    sp.add_argument("-s", "--settings", required=True)
    sp.add_argument("--strict-reference", action="store_true")
    sp.set_defaults(fn=cmd_plan)

    sp = sub.add_parser("synth", help="generate a synthetic IQ recording")
    sp.add_argument("-s", "--settings", required=True)
    sp.add_argument("--out", required=True)
    sp.add_argument("--seconds", type=float, default=2.0)
    sp.add_argument("--tone", type=float, default=1000.0)
    sp.add_argument("--amplitude", type=float, default=25.0)
    sp.add_argument("--noise", type=float, default=1.0)
    sp.add_argument("--dc", type=float, default=0.0)
    sp.add_argument("--format", default="u8", choices=["u8", "cf32"])
    sp.add_argument("--only", default=None, help="comma-separated topics to include")
    sp.set_defaults(fn=cmd_synth)

    sp = sub.add_parser("process-file", help="offline IQ file -> audio files/ZMQ")
    _common(sp, iq_required=True)
    sp.add_argument("--out", default=None, help="output directory for audio files")
    sp.add_argument("--zmq", action="store_true", help="also publish over ZMQ")
    sp.add_argument(
        "--spectrum", default=None, metavar="TAP",
        help="export an EMA spectrum of a tap ('main', 'g<i>', or a VFO topic) to --out",
    )
    sp.add_argument("--resume", default=None, help="resume from a state checkpoint")
    sp.add_argument("--save-state", default=None, help="write the final state checkpoint here")
    sp.add_argument("--wav", action="store_true", help="also write .wav audio files")
    sp.add_argument(
        "--burst", type=int, default=1, metavar="K",
        help="process K ingest blocks per step_many call (offline throughput; "
        "outputs still per block, in order)",
    )
    sp.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of the run to DIR/trace.json")
    sp.add_argument("--spectrum-png", action="store_true", help="render the spectrum to PNG")
    _trace_arg(sp)
    sp.set_defaults(fn=cmd_process_file)

    sp = sub.add_parser("run", help="live receive -> ZMQ (rtl_tcp, local USB or looped file)")
    _common(sp)
    sp.add_argument("--fast", action="store_true", help="don't pace --iq to realtime")
    sp.add_argument(
        "--control-port", type=int, default=None,
        help="UDP JSON control socket (set_center_freq / set_bias_tee / stats; "
        "with --scope also set_scope / set_fft / spectrum)",
    )
    sp.add_argument(
        "--scope", nargs="?", const="main", default=None, metavar="TAP",
        help="enable the live scope on TAP ('main', 'g<i>', or a VFO topic; "
        "default main), switchable at run time via --control-port",
    )
    _trace_arg(sp)
    sp.set_defaults(fn=cmd_run)

    sp = sub.add_parser("devices", help="list attached RTL USB devices")
    sp.set_defaults(fn=cmd_devices)

    sp = sub.add_parser("bench", help="throughput benchmark")
    _common(sp)
    sp.add_argument("--blocks", type=int, default=20)
    sp.set_defaults(fn=cmd_bench)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        if getattr(args, "trace_out", None):
            from ..obs import trace

            trace.enable()  # a fresh record for this command; _trace_out writes it
        return args.fn(args)
    except SystemExit as e:
        if isinstance(e.code, str):
            print(e.code, file=sys.stderr)
            return 1
        raise
    except (FileNotFoundError, ValueError, IOError) as e:
        # configuration and usage errors get a one-line message
        print(f"error: {e}", file=sys.stderr)
        return 1
    finally:
        if getattr(args, "trace_out", None):
            from ..obs import trace

            trace.disable()
        if getattr(args, "coordinator", None):
            from ..dist import multihost

            multihost.shutdown()


if __name__ == "__main__":
    sys.exit(main())
