"""Command-line entry points of the PyTorch port.

    python -m sdrreceiver_tpu_torch process-file -s rx.ini --iq rec.u8 --out DIR --device cuda

Port of ``sdrreceiver_tpu.cli.main``'s offline subcommands, with its flags
and output files:

  plan          print the compiled channelizer plan for an ini (JSON)
  synth         generate a synthetic USB-channel IQ recording
  process-file  offline: IQ recording in, per-channel audio files out
                (and/or ZMQ egress, a spectrum, a state checkpoint)

``--device`` picks the torch device (default ``cuda``; asking for it
without a card is an error, never a fall back to the CPU).  ``--plain``
runs the kernels' plain PyTorch versions (``use_kernels=False``).  The
live ``run`` entry, ``devices``, ``bench`` and the ``dist/`` options
(``--mesh``, ``--coordinator``, ``--partition global``) are not ported
yet; the last three exit 1 with a message.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np


def _build(args, taps=()):
    """(plan, receiver) for a command; ``SystemExit`` for options the port
    does not have yet or a device it cannot use."""
    import torch

    from ..graph.compiler import CompiledReceiver
    from ..graph.config import load_ini
    from ..graph.plan import build_plan

    if args.mesh or args.coordinator or args.partition == "global":
        raise SystemExit("error: dist/ is not ported yet (--mesh, --coordinator, --partition global)")
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"error: --device {args.device} requested but CUDA is not available")
    plan = build_plan(load_ini(args.settings), strict_reference=args.strict_reference)
    return plan, CompiledReceiver(
        plan, args.block, emit_taps=tuple(taps), device=args.device,
        use_kernels=not args.plain,
    )


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


def cmd_process_file(args) -> int:
    from ..core import checkpoint
    from ..core.runtime import run_pipeline
    from ..io import iqfile, zmqpub
    from ..obs.spectrum import SpectrumEMA

    plan, rx = _build(args, taps=(args.spectrum,) if args.spectrum else ())
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
            return_state=True, burst=args.burst,
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
    out["outputs_written"] = sorted(written)
    out["realtime_factor"] = round(metrics.samples_per_second / plan.fs, 2)
    print(json.dumps(out))
    return 0


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
    sp.add_argument("-s", "--settings", required=True, help="ini file")
    sp.add_argument("--iq", required=True, help="IQ recording path")
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
    sp.add_argument("--mesh", default=None, metavar="TxC", help="not ported yet (dist/)")
    sp.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                    help="not ported yet (dist/)")
    sp.add_argument("--partition", default="groups", choices=["groups", "global"],
                    help="'global' is not ported yet (dist/)")
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
    sp.set_defaults(fn=cmd_process_file)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
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


if __name__ == "__main__":
    sys.exit(main())
