"""Device time of the two CUDA kernels at the receivers' shapes, beside
their bounds (needs a CUDA device).

    python3 sdrreceiver_tpu_torch/cuda/devtime.py [--root DIR] [--calls N]
    python3 sdrreceiver_tpu_torch/cuda/devtime.py --ab OTHER_ROOT
    python3 sdrreceiver_tpu_torch/cuda/devtime.py --steps
    python3 sdrreceiver_tpu_torch/cuda/devtime.py --steps --procs

The first form times the kernels of the ``sdrreceiver_tpu_torch`` package
found under ``--root`` (default: this file's checkout), with the sharded
receiver's per-shard sites where that package has ``dist/``, and the
flagship ``step_u8`` at block 1,536,000, and prints one JSON line.  ``--ab``
runs that form in turns, OTHER_ROOT, this checkout, this checkout,
OTHER_ROOT, each in a process of its own on the same card, and prints both
versions' times for each case both have: the way to compare a change with
its parent (unpack the parent with ``git archive`` into a gitignored
directory).  Only the package's public wrappers are used (``DcIngest``,
``CompiledReceiver.mix_cascades``), so any version of the port can be
timed.  ``--steps`` profiles whole flagship steps instead: one device
eager, as a CUDA graph and as a graph with stateful buckets (in turns),
and 4x1, 2x2 and 1x4 meshes of the card, eager and with a graph per phase
(in turns): wall time, device time, CUDA rows per step, the device's idle
share, and the rows each adds over the one-device step (eager, or the
graph for the graph cases).  ``--steps --procs`` profiles a ``--partition
global`` mesh 2x1 over two processes of this script, eager and with graphs
per phase in turns, at both blocks: process 0's wall time, device time,
CUDA rows and idle share, the transport of its exchanges, and the graphs,
transfers, host exchanges and NCCL rows one replay makes.  With one card
both processes share it and exchange through gloo (the host's part of
each exchange timed too); with two or more each takes its own card and
exchanges through NCCL inside the graphs, beside the same graphs with
their exchanges staged through gloo.

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
# the sharded receiver's per-shard sites: a plan, its block and a mesh shape
# over the shards of one card (2x1 at 384,000: a global 2x3's shard site)
MESH_PLANS = [("flagship", 1_536_000, (4, 1)), ("flagship", 384_000, (2, 1))]


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


def device_us(fn, calls: int, row_us: dict | None = None,
              tries: int = 3, wall: dict | None = None) -> tuple[float, dict[str, int]]:
    """(µs of device time per call, {CUDA row name: rows per call}) over
    ``calls`` calls of ``fn`` after 5 warm-up calls; ``row_us``, when
    given, receives each row's µs per call, and ``wall`` the profiled
    calls' ms per call by CUDA events (``wall["ms"]``), the time the
    device time is a share of.

    The profiler loses device records at the start of a trace (a step's
    first kernel and memset counted 9 times in 10 steps, a kernel 44 times
    in 50 calls), so each profile first runs a warm-up cycle of 2 calls
    whose records are dropped (``schedule(warmup=1)``).  A profile with no
    CUDA row, or in which some row is still not a whole number per call,
    is taken again, up to ``tries`` times; the last one is returned either
    way, so a caller that checks the rows still sees it."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    for attempt in range(tries):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):
                fn()
            torch.cuda.synchronize()
            prof.step()
            start.record()
            for _ in range(calls):
                fn()
            end.record()
            torch.cuda.synchronize()
            prof.step()
        total, counts, times = 0.0, {}, {}
        for e in prof.key_averages():
            # the schedule's own span ("ProfilerStep#2") is no device work
            if (e.device_type != torch.autograd.DeviceType.CUDA
                    or e.key.startswith("ProfilerStep")):
                continue
            t = getattr(e, "self_device_time_total", None)
            if t is None:
                t = e.self_cuda_time_total
            total += t
            counts[e.key] = e.count
            times[e.key] = t / calls
        if counts and all(n % calls == 0 for n in counts.values()):
            break
        print(f"devtime: profile {attempt + 1} lost device records {counts}", file=sys.stderr)
    if row_us is not None:
        row_us.update(times)
    if wall is not None:
        wall["ms"] = start.elapsed_time(end) / calls
    return total / calls, {k: n / calls for k, n in counts.items()}


def lockstep_us(fn, calls: int, row_us: dict | None = None,
                wall: dict | None = None, tries: int = 3) -> tuple[float, dict[str, int]]:
    """:func:`device_us` in every process of a gloo group at once, each
    stepping ``fn`` (whose steps exchange data) the same number of times:
    the profile is taken again in all of them while any of them lost
    device records."""
    import torch.distributed as dist

    for _ in range(tries):
        us, rows = device_us(fn, calls, row_us, tries=1, wall=wall)
        whole = [None] * dist.get_world_size()
        dist.all_gather_object(whole, bool(rows) and all(float(n).is_integer()
                                                         for n in rows.values()))
        if all(whole):
            break
    return us, rows


def measure(calls: int = 50, seed: int = 0, step: bool = True) -> list[dict]:
    """Every kernel case: its device time, kernel rows per call and bound;
    the sharded receiver's per-shard sites too where the package has
    ``dist/``; with ``step``, the flagship step's wall time last."""
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
    receivers = []
    for plan_name, block in MC_PLANS:
        cfg = (flagship.benchmark_config if plan_name == "flagship" else flagship.altrate_config)()
        receivers.append((f"{plan_name} block {block}",
                          CompiledReceiver(build_plan(cfg), block, device=dev)))
    if (pathlib.Path(flagship.__file__).parent / "dist").is_dir():
        from sdrreceiver_tpu_torch.dist import ShardedReceiver, make_mesh

        for plan_name, block, (n_time, n_chan) in MESH_PLANS:
            cfg = (flagship.benchmark_config if plan_name == "flagship" else flagship.altrate_config)()
            rx = ShardedReceiver(build_plan(cfg), make_mesh(n_time, n_chan, [dev] * (n_time * n_chan)),
                                 block)
            receivers.append((f"{plan_name} mesh {n_time}x{n_chan} block {block}", rx))
    for name, rx in receivers:
        for site, (mc, t_len) in rx.mix_cascades().items():
            x = torch.tensor(rng.uniform(-128, 128, (2, 1, t_len)).astype(np.float32), device=dev)
            ph = torch.tensor(rng.integers(0, mc.fs, mc.channels), device=dev)
            us, rows = device_us(lambda: mc(ph, x[0], x[1]), calls)
            bound, by, moved, flops = mc_bound(mc.depths, t_len, shared=True)
            out.append({"kernel": "mix_cascade", "case": f"{name} {site}",
                        "C": mc.channels, "depths": sorted(set(mc.depths)), "T": t_len,
                        "device_us": us, "rows_per_call": rows, "bound_us": bound,
                        "bound_by": by, "bytes": moved, "fp64_flops": flops})
    if step:
        out.append(step_case(1_536_000, seed))
    return out


def step_case(block: int, seed: int, steps: int = 20) -> dict:
    """The flagship ``step_u8`` at ``block`` (the receiver's default path:
    CUDA graphs where the package has them): wall time per step by CUDA
    events around ``steps`` steps after 3 warm-up steps (an eager step is
    host-bound: the events time the host's launches, which is its cost)."""
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


def step_profile(rx, raw, calls: int, lockstep: bool = False) -> dict:
    """``rx.step_u8`` alternating over ``raw [2, 2T]``: wall ms per step
    (CUDA events around ``calls`` steps, outside the profiler), and under
    ``torch.profiler`` device µs, CUDA rows (kernels, memsets, copies) and
    the profiled steps' wall ms (the profiler slows the host); the device's
    idle share against the wall time outside the profiler; each row's µs
    and count.  ``lockstep``: ``rx`` is one process's receiver of a mesh
    across processes (:func:`lockstep_us`)."""
    import torch

    st = {"s": rx.init_state(), "i": 0}

    def step():
        st["i"] ^= 1
        st["s"], _ = rx.step_u8(st["s"], raw[st["i"]])

    row_us: dict[str, float] = {}
    wall: dict = {}
    us, rows = (lockstep_us if lockstep else device_us)(step, calls, row_us, wall=wall)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        step()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / calls
    return {"wall_ms": ms, "profiled_ms": wall["ms"],
            "device_us": us, "rows_per_step": sum(rows.values()),
            "idle_share": 1.0 - us / 1e3 / ms,
            "mix_cascade_us": sum(v for k, v in row_us.items() if "mix_cascade" in k),
            "rows": {k: [row_us[k], n] for k, n in rows.items()}}


def step_profiles(calls: int = 10, seed: int = 0) -> list[dict]:
    """Where a step's time goes: the flagship ``step_u8`` at 1,536,000 and
    384,000 on one device, eager ("one device", ``cuda_graphs=False``), as
    a CUDA graph, and as a graph with its buckets on the stateful path (a
    mesh's bucket path, without the mesh), these three in turns (eager,
    graph, stateful, stateful, graph, eager; the two profiles of each
    averaged, rows from the second); then on 4x1, 2x2 and 1x4 meshes of
    four shards of the card, eager (``cuda_graphs=False``) and with a
    graph per phase, in turns (eager, graph, graph, eager).  Each case as
    :func:`step_profile`."""
    import numpy as np
    import torch

    from sdrreceiver_tpu_torch import flagship
    from sdrreceiver_tpu_torch.dist import ShardedReceiver, make_mesh
    from sdrreceiver_tpu_torch.graph.compiler import CompiledReceiver
    from sdrreceiver_tpu_torch.graph.plan import build_plan

    plan = build_plan(flagship.benchmark_config())
    dev = torch.device("cuda", torch.cuda.current_device())
    out = []
    for block in (1_536_000, 384_000):
        raw = torch.tensor(np.random.default_rng(seed).integers(100, 156, (2, 2 * block),
                                                                 dtype=np.uint8), device=dev)
        # one device with its buckets on the stateful path, as under a mesh
        stateful = CompiledReceiver(plan, block, device=dev)
        stateful._bucket_mc = {}
        single = {"one device": CompiledReceiver(plan, block, device=dev, cuda_graphs=False),
                  "one device, graph": CompiledReceiver(plan, block, device=dev),
                  "one device, graph, stateful buckets": stateful}
        out += _in_turns(single, [*single, *reversed(single)], f"flagship block {block} ",
                         raw, calls)
        for t, c in ((4, 1), (2, 2), (1, 4)):
            mesh = {"": ShardedReceiver(plan, make_mesh(t, c, [dev] * 4), block,
                                        cuda_graphs=False),
                    ", graph": ShardedReceiver(plan, make_mesh(t, c, [dev] * 4), block)}
            out += _in_turns(mesh, ["", ", graph", ", graph", ""],
                             f"flagship block {block} mesh {t}x{c}", raw, calls)
    return out


def proc_step_profiles(calls: int = 10, seed: int = 0, timeout: float = 900) -> list[dict]:
    """The ``--steps`` cases of a ``--partition global`` mesh 2x1 over two
    processes of this script (:func:`proc_child`), both on the card, or
    each on its own card where there are two: process 0's profiles, its
    last line of output."""
    import socket

    import torch

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{sk.getsockname()[1]}"
    root = pathlib.Path(__file__).resolve().parents[2]
    distinct = torch.cuda.device_count() >= 2
    envs = [dict(os.environ, PYTHONPATH=str(root),
                 **({"CUDA_VISIBLE_DEVICES": str(i)} if distinct else {})) for i in (0, 1)]
    procs = [subprocess.Popen([sys.executable, str(pathlib.Path(__file__).resolve()),
                               "--proc-child", coord, str(i), str(calls), str(seed)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
             for i, env in zip((0, 1), envs)]
    try:
        res = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, (_, se)) in enumerate(zip(procs, res)):
        if p.returncode:
            sys.exit(f"devtime: process {i} of the global mesh exited {p.returncode}:\n"
                     f"{se[-4000:]}")
    return json.loads(res[0][0].strip().splitlines()[-1])["steps"]


def proc_child(coord: str, pid: int, calls: int, seed: int) -> None:
    """One of :func:`proc_step_profiles`' two processes: the flagship on
    the global mesh 2x1 (this process's shard on its first visible card)
    at 1,536,000 and 384,000, eager and with graphs per phase in turns
    (eager, graph, graph, eager; where the exchanges are NCCL's, the graphs
    with gloo exchanges too: eager, graph, gloo graph, gloo graph, graph,
    eager), every profile taken in both processes at once; prints the
    cases, with each one's transport and what one replay makes, and for
    the gloo paths the host's time at the exchanges."""
    from sdrreceiver_tpu_torch import flagship
    from sdrreceiver_tpu_torch.dist import multihost
    from sdrreceiver_tpu_torch.graph.plan import build_plan

    multihost.initialize(coord, 2, pid)
    try:
        mesh = multihost.global_mesh(1, ["cuda:0"])
        plan = build_plan(flagship.benchmark_config())
        # each block's receivers are gone before the process group is left:
        # a graph that captured NCCL collectives holds their communicator
        out = [c for block in (1_536_000, 384_000)
               for c in _proc_cases(mesh, plan, block, calls, seed)]
        print(json.dumps({"steps": out}))
    finally:
        multihost.shutdown()


def _proc_cases(mesh, plan, block: int, calls: int, seed: int) -> list[dict]:
    """:func:`proc_child`'s cases at one block."""
    import numpy as np
    import torch

    from sdrreceiver_tpu_torch.dist import ShardedReceiver, multihost

    raw = torch.tensor(np.random.default_rng(seed).integers(
        100, 156, (2, 2 * block), dtype=np.uint8), device=mesh.home)
    rxs = {"": ShardedReceiver(plan, mesh, block, cuda_graphs=False),
           ", graph": ShardedReceiver(plan, mesh, block)}
    order = ["", ", graph", ", graph", ""]
    if rxs[", graph"].exchange == "nccl":
        rxs[", graph, gloo"] = ShardedReceiver(plan, mesh, block)
        rxs[", graph, gloo"]._span = multihost.ProcessSpan(mesh, transport="staged")
        order = ["", ", graph", ", graph, gloo", ", graph, gloo", ", graph", ""]
    cases = _in_turns(rxs, order,
                      f"flagship block {block} global mesh 2x1, process {mesh.rank} of 2",
                      raw, calls, lockstep=True)
    for case, rx in zip(cases, rxs.values()):
        case["exchange"] = rx.exchange
        case["nccl_rows"] = sum(n for k, (_, n) in case["rows"].items() if "nccl" in k.lower())
        if rx._graphs is not None:
            (entry,) = rx._graphs._entries.values()
            t = entry.body.transfers
            case.update(graphs=entry.graph.graphs, transfers=len(t.bufs),
                        exchanges=t.exchanges, host_exchanges=len(t.hosts))
        if rx._span.transport == "staged":
            case["exchange_ms"] = [exchange_ms(rx, raw) for _ in range(2)]
    return cases


def exchange_ms(rx, raw, steps: int = 20) -> dict:
    """Where the host's time goes at the exchanges of ``rx``, one process's
    receiver of a mesh across processes: over ``steps`` steps after 3
    (host clock, every process stepping at once), the wall ms per step and,
    per exchange of a step in call order, its kind, the ms the host waits
    for the cards before it (the graphs' ``_Exchange.wait``; the eager
    step's copies wait inside ``ProcessSpan.eager``, not counted) and the
    ms in its gloo call."""
    import time

    import torch

    from sdrreceiver_tpu_torch.dist import meshgraph, multihost

    log: list[tuple[str, str, float]] = []
    comm, wait = multihost.ProcessSpan.communicate, meshgraph._Exchange.wait

    def timed_comm(span, kind, send, recv):
        t0 = time.perf_counter()
        comm(span, kind, send, recv)
        log.append((kind, "gloo", time.perf_counter() - t0))

    def timed_wait(ex):
        t0 = time.perf_counter()
        wait(ex)
        log.append((ex.kind, "wait", time.perf_counter() - t0))

    st = rx.init_state()
    for i in range(3):
        st, _ = rx.step_u8(st, raw[i % 2])
    torch.cuda.synchronize()
    multihost.ProcessSpan.communicate, meshgraph._Exchange.wait = timed_comm, timed_wait
    try:
        t0 = time.perf_counter()
        for i in range(steps):
            st, _ = rx.step_u8(st, raw[i % 2])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    finally:
        multihost.ProcessSpan.communicate, meshgraph._Exchange.wait = comm, wait
    gloo = [(k, t) for k, what, t in log if what == "gloo"]
    waits = [t for _, what, t in log if what == "wait"]
    n = len(gloo) // steps
    per = []
    for j in range(n):
        calls = range(j, len(gloo), n)
        per.append([gloo[j][0],
                    1e3 * sum(waits[i] for i in calls) / steps if waits else 0.0,
                    1e3 * sum(gloo[i][1] for i in calls) / steps])
    return {"wall_ms": wall, "exchanges": per}


def _in_turns(rxs: dict, order: list[str], prefix: str, raw, calls: int,
              lockstep: bool = False) -> list[dict]:
    """:func:`step_profile` of each receiver of ``rxs`` in ``order`` (each
    twice); per receiver one case ``prefix + name`` with the two profiles'
    times averaged and the second one's rows."""
    turns: dict[str, list[dict]] = {k: [] for k in rxs}
    for name in order:
        turns[name].append(step_profile(rxs[name], raw, calls, lockstep))
    out = []
    for name, (a, b) in turns.items():
        avg = {k: (a[k] + b[k]) / 2 for k in ("wall_ms", "profiled_ms", "device_us",
                                              "idle_share", "mix_cascade_us")}
        out.append({"case": prefix + name, **b, **avg,
                    "turns_wall_ms": [a["wall_ms"], b["wall_ms"]]})
    return out


def mesh_extra(steps: list[dict], top: int = 8) -> dict[str, list]:
    """For each mesh case of :func:`step_profiles` and each graph case, the
    rows whose device time grew most over the eager one-device step at the
    same block (the graph with stateful buckets and a mesh's graphs: over
    the one-device graph): ``[row, µs more, rows more]`` per step."""
    out = {}
    for c in steps:
        block, _, name = c["case"].partition(" mesh ")
        over_graph = name.endswith(", graph")
        if not name:
            block, _, name = c["case"].partition(" one device, ")
            over_graph = "stateful" in name
        if not name:
            continue
        base = f"{block} one device" + (", graph" if over_graph else "")
        one = next(o["rows"] for o in steps if o["case"] == base)
        keys = set(c["rows"]) | set(one)
        diff = [[k, c["rows"].get(k, [0, 0])[0] - one.get(k, [0, 0])[0],
                 c["rows"].get(k, [0, 0])[1] - one.get(k, [0, 0])[1]] for k in keys]
        out[c["case"]] = sorted(diff, key=lambda d: -d[1])[:top]
    return out


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
        cases = json.loads(res.stdout.strip().splitlines()[-1])["cases"]
        runs.append({(c["kernel"], c["case"]): c for c in cases})
    print(f"card: {card()}")
    rows = []
    # the cases both versions have (the per-shard sites need dist/)
    for key, case in runs[0].items():
        if key not in runs[1]:
            continue
        if "step_ms" in case:
            t = [r[key]["step_ms"] for r in runs]
            rows.append({"kernel": case["kernel"], "case": case["case"],
                         "other_ms": [t[0], t[3]], "here_ms": [t[1], t[2]]})
            print(f"{case['kernel']:12s} {case['case']:40s} other {t[0]:8.3f} / {t[3]:8.3f} ms, "
                  f"here {t[1]:8.3f} / {t[2]:8.3f} ms (wall time per step)")
            continue
        t = [r[key]["device_us"] for r in runs]
        here_case = runs[1][key]
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
    ap.add_argument("--steps", action="store_true",
                    help="profile whole steps instead: one device against meshes on the card")
    ap.add_argument("--procs", action="store_true",
                    help="with --steps: a global mesh 2x1 over two processes on the card")
    ap.add_argument("--proc-child", nargs=4, metavar=("COORD", "PID", "CALLS", "SEED"),
                    help=argparse.SUPPRESS)
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
    if args.proc_child:
        coord, pid, calls, seed = args.proc_child
        proc_child(coord, int(pid), int(calls), int(seed))
        # no interpreter teardown: the process group is left, and what torch
        # still holds of NCCL can only delay the end
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(0)
    if args.steps:
        steps = proc_step_profiles() if args.procs else step_profiles()
        for c in steps:
            per_replay = (f"; {c['exchange']} exchanges, {c['nccl_rows']:g} NCCL rows a step"
                          if "exchange" in c else "")
            if "graphs" in c:
                per_replay += (f", {c['graphs']} graphs, {c['transfers']} transfers and "
                               f"{c['host_exchanges']} host exchanges of {c['exchanges']} a replay")
            print(f"{c['case']:58s} wall {c['wall_ms']:8.3f} ms (profiled "
                  f"{c['profiled_ms']:8.3f}), device {c['device_us']:8.1f} us over "
                  f"{c['rows_per_step']:.0f} CUDA rows (mix_cascade {c['mix_cascade_us']:.1f} "
                  f"us), idle {c['idle_share']:.3f}{per_replay}")
            for x in c.get("exchange_ms", []):
                print(f"    host clock: {x['wall_ms']:.3f} ms a step; per exchange [kind, ms "
                      f"waiting for the card, ms in gloo]: "
                      f"{[[k, round(w, 4), round(g, 4)] for k, w, g in x['exchanges']]}")
        extra = {} if args.procs else mesh_extra(steps)
        for case, diff in extra.items():
            over_graph = "stateful" in case or (" mesh " in case and case.endswith(", graph"))
            base = "the one-device graph" if over_graph else "one device, eager"
            print(f"{case}: most device time added over {base}:")
            for k, dus, dn in diff:
                print(f"    {dus:+9.1f} us {dn:+6.0f} rows  {k[:90]}")
        for c in steps:
            del c["rows"]
        print(json.dumps({"card": card(), "steps": steps, "mesh_extra": extra}))
        return
    cases = measure(args.calls)
    print(json.dumps({"root": str(args.root), "card": card(), "cases": cases}))


if __name__ == "__main__":
    main()
