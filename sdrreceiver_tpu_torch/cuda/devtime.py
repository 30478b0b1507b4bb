"""Device time of the two CUDA kernels at the receivers' shapes, beside
their bounds (needs a CUDA device).

    python3 sdrreceiver_tpu_torch/cuda/devtime.py [--root DIR] [--calls N]
    python3 sdrreceiver_tpu_torch/cuda/devtime.py --ab OTHER_ROOT

The first form times the kernels of the ``sdrreceiver_tpu_torch`` package
found under ``--root`` (default: this file's checkout), and the flagship
``step_u8`` at block 1,536,000, and prints one JSON line.  ``--ab`` runs that form in turns, OTHER_ROOT, this checkout, this
checkout, OTHER_ROOT, each in a process of its own on the same card, and
prints both versions' times per case: the way to compare a change with its
parent (unpack the parent with ``git archive`` into a gitignored
directory).  Only the package's public wrappers are used (``DcIngest``,
``CompiledReceiver.mix_cascades``), so any version of the port can be timed.

Device time is ``torch.profiler``'s: the CUDA rows (kernels and memsets) of
``key_averages`` over ``calls`` back-to-back wrapper calls after a warm-up,
summed per call.  The bound is the larger of the bytes the function must
move (each input read once, each output written once) over 3.35 TB/s and
its float64 operations over 67 TFLOP/s (an H100 SXM's FP64 tensor-core
peak; 34 TFLOP/s without the tensor cores); the DC filter's float32 work
is negligible beside its bytes.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys

HBM_BYTES_PER_S = 3.35e12
FP64_FLOPS = 67e12

# (case, what): dc cases are (u8/f32, T); mix cases a plan, its block and a
# site of CompiledReceiver.mix_cascades()
DC_CASES = [("u8", 1_536_000), ("u8", 384_000), ("f32", 480_000), ("u8", 4224), ("u8", 72_000)]
MC_PLANS = [("flagship", 1_536_000), ("flagship", 384_000), ("altrate", 480_000)]


def dc_bound(kind: str, t_len: int) -> tuple[float, str]:
    """(bound µs, "bytes"): interleaved input read once, two float32 planes
    written once."""
    moved = t_len * (2 if kind == "u8" else 8) + t_len * 8
    return 1e6 * moved / HBM_BYTES_PER_S, "bytes"


def mc_bound(depths, t_len: int, shared: bool) -> tuple[float, str, float, float]:
    """(bound µs, bound_by, bytes, float64 flops) of one mix-cascade call:
    the input read once, the outputs written once; per channel the complex
    mix (6 flops a sample) and the composite FIR (10 (2^d - 1) + 1 real
    taps on a complex sample, 4 flops a tap, T >> d outputs)."""
    n_in = 1 if shared else len(depths)
    moved = 8 * t_len * n_in + sum(8 * (t_len >> d) for d in depths)
    flops = sum(6 * t_len + 4 * (10 * ((1 << d) - 1) + 1) * (t_len >> d) for d in depths)
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, flops / FP64_FLOPS
    return 1e6 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), moved, flops


def joint_bound(cases: list[dict]) -> tuple[float, str]:
    """(bound µs, bound_by) of several mix-cascade calls together: their
    bytes and their float64 operations, summed."""
    moved, flops = sum(c["bytes"] for c in cases), sum(c["fp64_flops"] for c in cases)
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, flops / FP64_FLOPS
    return 1e6 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def device_us(fn, calls: int) -> tuple[float, dict[str, int]]:
    """(µs of device time per call, {CUDA row name: rows per call}) over
    ``calls`` calls of ``fn`` after 5 warm-up calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total, rows = 0.0, {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        total += t
        rows[e.key] = e.count / calls
    return total / calls, rows


def measure(calls: int = 50, seed: int = 0, step: bool = True) -> list[dict]:
    """Every kernel case: its device time, kernel rows per call and bound;
    with ``step``, the flagship step's wall time last."""
    import numpy as np
    import torch

    from sdrreceiver_tpu_torch import flagship
    from sdrreceiver_tpu_torch.cuda.dckernel import DcIngest
    from sdrreceiver_tpu_torch.graph.compiler import CompiledReceiver
    from sdrreceiver_tpu_torch.graph.plan import build_plan

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    out = []
    dck = DcIngest()
    mean = torch.tensor([3.25, -1.5], dtype=torch.float32, device=dev)
    for kind, t_len in DC_CASES:
        raw = torch.tensor(rng.integers(0, 256, 2 * t_len, dtype=np.uint8), device=dev)
        if kind == "f32":
            raw = raw.float() - 127.0
        us, rows = device_us(lambda: dck(mean, raw), calls)
        bound, by = dc_bound(kind, t_len)
        out.append({"kernel": "dc_ingest", "case": f"{kind} T={t_len}", "device_us": us,
                    "rows_per_call": rows, "bound_us": bound, "bound_by": by})
    for plan_name, block in MC_PLANS:
        cfg = (flagship.benchmark_config if plan_name == "flagship" else flagship.altrate_config)()
        rx = CompiledReceiver(build_plan(cfg), block, device=dev)
        for site, (mc, t_len) in rx.mix_cascades().items():
            x = torch.tensor(rng.uniform(-128, 128, (2, 1, t_len)).astype(np.float32), device=dev)
            ph = torch.tensor(rng.integers(0, mc.fs, mc.channels), device=dev)
            us, rows = device_us(lambda: mc(ph, x[0], x[1]), calls)
            bound, by, moved, flops = mc_bound(mc.depths, t_len, shared=True)
            out.append({"kernel": "mix_cascade", "case": f"{plan_name} block {block} {site}",
                        "C": mc.channels, "depths": sorted(set(mc.depths)), "T": t_len,
                        "device_us": us, "rows_per_call": rows, "bound_us": bound,
                        "bound_by": by, "bytes": moved, "fp64_flops": flops})
    if step:
        out.append(step_case(1_536_000, seed))
    return out


def step_case(block: int, seed: int, steps: int = 20) -> dict:
    """The flagship ``step_u8`` at ``block``: wall time per step by CUDA
    events around ``steps`` steps after 3 warm-up steps (host-bound: the
    events time the host's launches, which is the step's cost)."""
    import numpy as np
    import torch

    from sdrreceiver_tpu_torch import flagship
    from sdrreceiver_tpu_torch.graph.compiler import CompiledReceiver
    from sdrreceiver_tpu_torch.graph.plan import build_plan

    rx = CompiledReceiver(build_plan(flagship.benchmark_config()), block, device="cuda")
    rng = np.random.default_rng(seed)
    raw = torch.tensor(rng.integers(100, 156, (2, 2 * block), dtype=np.uint8), device="cuda")
    st = rx.init_state()
    for i in range(3):
        st, _ = rx.step_u8(st, raw[i % 2])
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for i in range(steps):
        st, _ = rx.step_u8(st, raw[i % 2])
    end.record()
    torch.cuda.synchronize()
    return {"kernel": "step_u8", "case": f"flagship block {block}",
            "step_ms": start.elapsed_time(end) / steps}


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def ab(other: pathlib.Path, here: pathlib.Path, calls: int) -> None:
    """OTHER, HERE, HERE, OTHER in processes of their own; both versions'
    times per case, and the mean of each pair."""
    runs = []
    for name, root in (("other", other), ("here", here), ("here", here), ("other", other)):
        res = subprocess.run(
            [sys.executable, str(pathlib.Path(__file__).resolve()), "--root", str(root),
             "--calls", str(calls)],
            capture_output=True, text=True, check=False,
        )
        if res.returncode:
            sys.exit(f"{name} ({root}) failed:\n{res.stdout[-4000:]}\n{res.stderr[-4000:]}")
        runs.append((name, json.loads(res.stdout.strip().splitlines()[-1])))
    print(f"card: {card()}")
    rows = []
    for i, case in enumerate(runs[0][1]["cases"]):
        if "step_ms" in case:
            t = [r["cases"][i]["step_ms"] for _, r in runs]
            rows.append({"kernel": case["kernel"], "case": case["case"],
                         "other_ms": [t[0], t[3]], "here_ms": [t[1], t[2]]})
            print(f"{case['kernel']:12s} {case['case']:40s} other {t[0]:8.3f} / {t[3]:8.3f} ms, "
                  f"here {t[1]:8.3f} / {t[2]:8.3f} ms (wall time per step)")
            continue
        t = [r["cases"][i]["device_us"] for _, r in runs]
        here_case = runs[1][1]["cases"][i]
        rows.append({"kernel": case["kernel"], "case": case["case"],
                     "other_us": [t[0], t[3]], "here_us": [t[1], t[2]],
                     "other_rows": case["rows_per_call"],
                     "here_rows": here_case["rows_per_call"],
                     "bound_us": here_case["bound_us"], "bound_by": here_case["bound_by"]})
        print(f"{case['kernel']:12s} {case['case']:40s} other {t[0]:8.2f} / {t[3]:8.2f} us, "
              f"here {t[1]:8.2f} / {t[2]:8.2f} us, bound {here_case['bound_us']:.2f} us "
              f"({here_case['bound_by']}), share of bound here "
              f"{here_case['bound_us'] / ((t[1] + t[2]) / 2):.3f}")
    print(json.dumps({"card": card(), "ab": rows}))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=pathlib.Path,
                    default=pathlib.Path(__file__).resolve().parents[2])
    ap.add_argument("--calls", type=int, default=50)
    ap.add_argument("--ab", type=pathlib.Path, default=None,
                    help="another checkout's root, timed in turns with this one")
    args = ap.parse_args(argv)
    if args.ab is not None:
        ab(args.ab.resolve(), pathlib.Path(__file__).resolve().parents[2], args.calls)
        return
    sys.path.insert(0, str(args.root.resolve()))
    os.chdir(args.root)
    import torch

    if not torch.cuda.is_available():
        sys.exit("devtime: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    cases = measure(args.calls)
    print(json.dumps({"root": str(args.root), "card": card(), "cases": cases}))


if __name__ == "__main__":
    main()
