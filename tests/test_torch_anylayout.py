"""The port's remaining global-mesh layouts on the CPU: a process whose
devices end one time row and begin the next (``dist/mesh.py``,
``dist/multihost.py``, ``dist/halo.py``, ``dist/sharded.py``).

The JAX package's ``global_mesh`` lays every process's devices out in
process order, in rows of ``n_chan``, and its SPMD step runs any such
layout.  Where a process's device count D is neither a multiple nor a
divisor of ``n_chan``, its devices end one time row and begin the next:

* **2x3** over three processes of two devices: rows ``p0 p0 p1`` and
  ``p1 p2 p2``; p1 computes both time shards;
* **3x2** over two processes of three: rows ``p0 p0``, ``p0 p1``, ``p1
  p1``; both compute the middle shard.

Every process computes the time shards of the rows it holds a device in;
one process of its time group publishes each shard to the time exchanges
(``Mesh.publishers``), and each split bucket's channel ranges are computed
once in the channel group (``Mesh.chan_owners``), the others gathered by
one padded ``"chan"`` all-gather a bucket.  The step processes of both
layouts (one CPU device each position) start once for the module, with
the two CLIs' runs of one ``process-file --partition global`` of each.
Each step process runs, on the same 3 u8 blocks, the eager step, the
``MeshGraphs`` body and a burst of k = 2, with the exchanges as
collectives (what distinct cards capture inside their graphs) and staged
(gloo on host buffers); the flagship plan at block 49,152 (the per-shard
mix-cascade; buckets of 11 and 15 channels split) and at a short block
(the stateful cascade).  The parent holds:

1. as plain cases: the layout against the JAX package's ``global_mesh``;
   every process's owner tables, exchange groups and buffer sizes; the
   channel exchange's packing at the new counts;
2. the eager step, the body and the burst bit-equal, on both transports;
3. each process computing exactly its time shards and its channel ranges,
   no range twice across the processes;
4. no host exchange, sync or upload in the collective body;
5. the union of the published topics bit-equal to the one-process mesh of
   the same shape;
6. within 1 LSB (flip rate < 1e-3) of the JAX package's ``ShardedReceiver``
   on the same mesh of virtual CPU devices, Pallas interpret and jnp;
7. the CLI run: every process exits 0 and writes its own topics, the union
   within 1 LSB of the JAX CLI's same run, the ``multihost`` blocks equal;
8. a step whose peer has gone raises, and the process exits non-zero.
"""

import inspect
import json
import os
import pathlib
import subprocess
import sys
import time
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from sdrreceiver_tpu.dist import ShardedReceiver as JShardedReceiver
from sdrreceiver_tpu.dist import make_mesh as jmake_mesh
from sdrreceiver_tpu.dist import multihost as jmultihost
from sdrreceiver_tpu.graph import build_plan as jbuild_plan
from sdrreceiver_tpu_torch.dist import Mesh, ShardedReceiver, multihost, sharded
from sdrreceiver_tpu_torch.dist.mesh import CHAN_AXIS, TIME_AXIS
from sdrreceiver_tpu_torch.flagship import benchmark_config
from sdrreceiver_tpu_torch.graph.plan import build_plan
from test_multihost_proc import INI_TMPL, _env
from test_torch_chanprocs import _equal, _raw
from test_torch_cli import _free_port
from test_torch_graphs import _HostHazards
from test_torch_receiver import _assert_audio_close

# six xdist workers share the machine's cores: a few torch threads each
torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
N_BLOCKS = 3
K = 2
#: layout -> (processes, devices a process, n_time, n_chan)
LAYOUTS = {"2x3": (3, 2, 2, 3), "3x2": (2, 3, 3, 2)}
#: layout -> case -> block (the flagship plan; the short block a multiple
#: of the divisor times n_time)
CASES = {"2x3": {"flagship": 49152, "short": 2048},
         "3x2": {"flagship": 49152, "short": 3072}}
TRANSPORTS = ("collective", "staged")
#: rows of each layout (process by position)
RANKS = {"2x3": [[0, 0, 1], [1, 2, 2]], "3x2": [[0, 0], [0, 1], [1, 1]]}
#: seconds the processes may take together
LIMIT = 120

PIDS = [(lay, pid) for lay, (n, *_) in LAYOUTS.items() for pid in range(n)]
STEPS = [(lay, case) for lay in LAYOUTS for case in CASES[lay]]

CHILD = '''
import contextlib
import sys
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from sdrreceiver_tpu_torch.cuda.dckernel import DcIngest
from sdrreceiver_tpu_torch.cuda.frontend import MixCascade
from sdrreceiver_tpu_torch.dist import ShardedReceiver, multihost, sharded
from sdrreceiver_tpu_torch.dist.meshgraph import MeshGraphs
from sdrreceiver_tpu_torch.flagship import benchmark_config
from sdrreceiver_tpu_torch.graph.plan import build_plan

torch.set_num_threads(2)

HAZARDS

def host(o):
    return {k: v.numpy() for k, v in o.items()}

#: bucket -> channels the split bucket steps of one step computed here
computed = {}
orig = sharded._ChanSlice._bucket_step
def counting(self, g, bi, *args):
    key = f"g{g.index}/b{bi}"
    computed[key] = computed.get(key, 0) + g.buckets[bi].channels
    return orig(self, g, bi, *args)
sharded._ChanSlice._bucket_step = counting

def run(graphs, rx, blocks, hz, r):
    """The body of ``graphs`` over the blocks (the first step builds its
    buffers; the others under the hazard check), then the burst."""
    r["body"], r["body_states"] = [], []
    s = rx.init_state()
    for i, b in enumerate(blocks):
        with hz if i else contextlib.nullcontext():
            s, o = graphs.step(s, b)
        r["body"].append(host(o))
        r["body_states"].append(rx.export_state(s))
    (entry,) = graphs._entries.values()
    t = entry.body.transfers
    r["per_step"] = {"transfers": t.calls, "exchanges": t.exchanges,
                     "hosts": [x.kind for x in t.hosts],
                     "collectives": [x.kind for x in t.collectives]}
    graphs.step(rx.init_state(), blocks[:KBURST])  # builds the burst's buffers
    s = rx.init_state()
    with hz:
        s, many = graphs.step(s, blocks[:KBURST])
    r["burst"] = [host(o) for o in rx.unstack_outputs(many, KBURST)]
    r["burst_state"] = rx.export_state(s)

def main(coord, pid, n_proc, n_local, n_chan, data, out):
    multihost.TIMEOUT_S = 60
    multihost.initialize(coord, n_proc, pid)
    mesh = multihost.global_mesh(n_chan, ["cpu"] * n_local)
    hz = _HostHazards()
    fronts = [0]
    for cls in (DcIngest, MixCascade):
        def inside(*args, _orig=cls.forward, _cls=cls):
            hz.inside += 1
            fronts[0] += _cls is MixCascade
            try:
                return _orig(*args)
            finally:
                hz.inside -= 1
        cls.forward = inside
    plan = build_plan(benchmark_config())
    span = multihost.ProcessSpan(mesh, transport="staged")
    res = {"layout": {"rows": mesh.rows(), "columns": mesh.columns(), "home": str(mesh.home),
                      "ranks": mesh.ranks, "own": [[j for j, _ in mesh.own(i)] for i in mesh.rows()],
                      "local": [str(d) for d in mesh.local()],
                      "publishers": mesh.publishers(), "chan_owners": mesh.chan_owners()},
           "span": {k: getattr(span, k) for k in (
               "lo", "hi", "n", "column", "row", "world", "time", "to", "prev", "next", "last",
               "halo_k", "published", "pad", "slots", "chan_pad", "chan_slots")}}
    for case, blocks in torch.load(data).items():
        for transport in TRANSPORTS:
            rx = ShardedReceiver(plan, mesh, blocks.shape[1] // 2)
            rx._span = multihost.ProcessSpan(mesh, transport=transport)
            r = res[case, transport] = {"eager": [], "eager_states": [],
                                        "shards": [i for i, _ in rx._shard_devices()],
                                        "parts": {k: [(lo, hi, p is not None) for lo, hi, _, p in v]
                                                  for k, v in rx._chan_parts.items()}}
            s = rx.init_state()
            for i, b in enumerate(blocks):
                computed.clear()
                fronts[0] = 0
                s, o = rx.step_u8(s, b)
                r["eager"].append(host(o))
                r["eager_states"].append(rx.export_state(s))
            r["computed"], r["fronts"] = dict(computed), fronts[0]
            graphs = MeshGraphs(rx)
            run(graphs, rx, blocks, hz, r)
            r["hazards"] = list(hz.found)
            hz.found.clear()
            res["graphs"] = graphs, blocks
    graphs, blocks = res.pop("graphs")
    torch.save(res, out)
    print("saved", flush=True)
    if pid == n_proc - 1:
        return 0  # the last process goes: the others' next exchange must fail
    s = graphs.state
    for i in range(50):
        s, _ = graphs.step(s, blocks[i % len(blocks)])
    print("stepped without its peer", flush=True)
    return 0

sys.exit(main(sys.argv[1], *map(int, sys.argv[2:6]), sys.argv[6], sys.argv[7]))
'''


def _fake_world(monkeypatch, pid: int, n_proc: int):
    """``multihost`` as process ``pid`` of ``n_proc`` processes with the
    same devices, its gathers answered locally."""
    class _Dist:
        def all_gather_object(self, out, mine):
            out[:] = [mine] * n_proc

    monkeypatch.setattr(multihost, "initialize", lambda: (pid, n_proc))
    monkeypatch.setattr(multihost, "_dist", _Dist)


# --------------------------------------------------- 1. plain: the layout
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_global_mesh_layout_equals_jax(monkeypatch, layout):
    """Each position (row, column, owning process) of the port's global
    mesh equals the JAX package's ``global_mesh`` over the processes'
    devices in process order; every process sees the same grid, its rows
    and its positions row by row."""
    n_proc, n_local, n_time, n_chan = LAYOUTS[layout]
    devs = jax.devices()[:n_proc * n_local]
    jm = jmultihost.global_mesh(n_chan, devs)
    theirs = [[devs.index(d) // n_local for d in row] for row in jm.devices]
    assert theirs == RANKS[layout]
    for pid in range(n_proc):
        _fake_world(monkeypatch, pid, n_proc)
        mesh = multihost.global_mesh(n_chan, ["cpu"] * n_local)
        assert mesh.shape == {TIME_AXIS: n_time, CHAN_AXIS: n_chan} == dict(jm.shape)
        assert mesh.ranks == theirs and mesh.rank == pid
        flat = [(i, j) for i in range(n_time) for j in range(n_chan)][pid * n_local:
                                                                       (pid + 1) * n_local]
        assert mesh.rows() == sorted({i for i, _ in flat})
        assert [(i, j) for i in mesh.rows() for j, _ in mesh.own(i)] == flat
        assert mesh.columns() == sorted({j for _, j in flat})
        assert mesh.home == mesh.local()[0] == torch.device("cpu") and len(mesh.local()) == 1


#: layout -> pid -> (rows, publishers' view: published, prev, to, halo_k,
#: last, pad, slots; the ranges it computes (position, row))
TABLES = {
    "2x3": {0: ([0], [], None, [], 0, 2, 1, [1, 2], [(0, 0)]),
            1: ([0, 1], [0], None, [2], 0, 2, 1, [1, 2], [(2, 0)]),
            2: ([1], [0], 1, [], 0, 2, 1, [1, 2], [(1, 1)])},
    "3x2": {0: ([0, 1], [0], None, [1], 0, 1, 2, [0, 2, 3], [(0, 0)]),
            1: ([1, 2], [0, 1], 0, [], 1, 1, 2, [0, 2, 3], [(1, 1)])},
}


@pytest.mark.parametrize("layout, pid", PIDS)
def test_owner_tables_groups_and_buffers(monkeypatch, layout, pid):
    """Every process of the layout: its time and channel groups (every
    process: one links them all through shared columns and rows), who
    publishes each time shard (the last of its row's processes), the halo
    (from the publisher of the shard before its first, to the processes
    whose first shard follows its published one), the gather's padding
    and slots, the ranges it computes (its first gcd(n_chan, D) positions:
    each range once), the channel exchange's padding and slots, its
    groups (the world's: gloo's default group, NCCL's own) and the
    buffers of every exchange."""
    n_proc, n_local, n_time, n_chan = LAYOUTS[layout]
    rows, published, prev, to, halo_k, last, pad, slots, ranges = TABLES[layout][pid]
    world = list(range(n_proc))
    fake = _Groups()
    monkeypatch.setattr(multihost, "_groups", {})
    monkeypatch.setattr(multihost, "_dist", lambda: fake)
    mesh = Mesh([["cpu"] * n_chan] * n_time, RANKS[layout], rank=pid)
    assert mesh.rows() == rows
    assert mesh.partition(TIME_AXIS) == mesh.partition(CHAN_AXIS) == [world]
    assert mesh.column_ranks() == mesh.row_ranks() == world
    owners = mesh.chan_owners()
    assert sorted(j for j, (q, _) in enumerate(owners) if q == pid) == [j for j, _ in ranges]
    assert all(owners[j] == (pid, i) and RANKS[layout][i][j] == pid for j, i in ranges)
    assert sorted(q for q, _ in owners) == ([0, 1, 2] if layout == "2x3" else [0, 1])
    span = multihost.ProcessSpan(mesh, transport="collective")
    assert (span.lo, span.hi, span.n, span.world, span.time) == (rows[0], rows[-1] + 1, n_time,
                                                                 n_proc, True)
    assert (span.column, span.row) == (world, world)
    assert span.published == published and span.prev == prev and span.to == to
    assert span.next == (to[0] if to else None)
    assert (span.halo_k, span.last, span.pad, span.slots) == (halo_k, last, pad, slots)
    # each shard's slot holds its publisher's value, each range's its owner's
    pubs = mesh.publishers()
    assert all(s // pad == pubs[i] for i, s in enumerate(slots))
    assert span.chan_pad == 1 and span.chan_slots == [q for q, _ in owners]
    # one group of both axes: the world, gloo's default group, NCCL's own
    assert (span.group, span.row_group, fake.calls) == (None, None, [])
    made = [multihost._exchange_groups(mesh.partition(ax), "nccl", world)
            for ax in (TIME_AXIS, CHAN_AXIS)]
    assert made[0] == made[1] == {tuple(world): "ncclworld"} and fake.calls == [("nccl", None)]
    v = torch.ones(pad, 4, 5)
    for kind, n in (("gather", n_proc * pad), ("chan", n_proc * pad), ("halo", pad)):
        send, recv = span.buffers(kind, v)
        assert send.shape == v.shape and recv.shape == (n, 4, 5) and not recv.any(), kind
    send, recv = span.buffers("last", v)
    assert send is recv


class _Groups:
    """A process group that records each ``new_group`` call."""

    def __init__(self):
        self.calls = []

    def new_group(self, ranks=None, backend=None, timeout=None):
        self.calls.append((backend, None if ranks is None else tuple(ranks)))
        return f"{backend}{'world' if ranks is None else tuple(ranks)}"


@pytest.mark.parametrize("counts, owners", [
    ([4, 4, 3], [0, 2, 1]), ([5, 5, 5], [0, 2, 1]), ([8, 7, 7], [0, 2, 1]), ([6, 5], [0, 1]),
    ([3, 3, 2, 2, 2], [0, 2, 0, 1, 2])],
    ids=["11/3", "15/3", "22/3", "11/2", "12/5 uneven"])
def test_chan_pack_round_trips_at_the_new_counts(counts, owners):
    """The channel exchange of a channel group whose ranges are not in
    rank order, or whose processes compute unequal numbers of them: each
    process packs its ranges (padded to the largest range) and zero rows
    up to the most any process computes, the all-gather stacks them in
    rank order, and ``chan_slots`` picks the ranges back in column order:
    the concatenation of every range, bit for bit."""
    rng = np.random.default_rng(5)
    m = max(counts)
    group = sorted(set(owners))
    pad, slots = multihost._slots(owners, group)
    assert pad == max(owners.count(q) for q in group)
    ranges = [[torch.from_numpy(rng.integers(-2**15, 2**15, (c, 3)).astype(np.int16)),
               torch.from_numpy(rng.integers(0, 2**40, (c,))),
               torch.from_numpy(rng.standard_normal((c, 2, 5)).astype(np.float32))]
              for c in counts]
    sent = []
    for q in group:
        packed = [sharded._pack(ranges[j], m) for j, o in enumerate(owners) if o == q]
        packed += [torch.zeros_like(packed[0])] * (pad - len(packed))
        sent.append(torch.stack(packed))
    rows = torch.cat(sent)  # the all-gather, in rank order
    assert rows.shape[0] == len(group) * pad
    full = sharded._unpack([rows[s] for s in slots], ranges[0], counts, m)
    for k, t in enumerate(full):
        want = torch.cat([items[k] for items in ranges])
        assert t.dtype == want.dtype and torch.equal(t, want), k


def test_mesh_refuses_what_no_global_mesh_produces():
    """A process whose positions are no contiguous run (its rows out of
    order), and a channel group whose ranges its processes' first
    positions cannot each cover once."""
    with pytest.raises(ValueError, match="contiguous"):
        Mesh([["cpu"] * 2] * 3, [[0, 1], [1, 0], [0, 1]], rank=0)
    mesh = Mesh([["cpu"] * 3] * 2, [[0, 0, 0], [0, 0, 1]], rank=1)
    with pytest.raises(ValueError, match="cover each chan position once"):
        mesh.chan_owners()


def test_replay_wait_gives_a_shared_group_up_once(monkeypatch):
    """Where the time and channel groups are both every process, one NCCL
    group serves both axes: a replay past its deadline aborts it once (two
    aborts of one communicator on two threads) and raises."""
    class _Pending:
        def query(self):
            return False

    given_up = []
    monkeypatch.setattr(multihost, "TIMEOUT_S", 0.1)
    monkeypatch.setattr(multihost, "_give_up", given_up.append)
    span = multihost.ProcessSpan(Mesh([["cpu"] * 3] * 2, RANKS["2x3"], rank=1))
    span.group = span.row_group = world = object()
    with pytest.raises(RuntimeError, match="NCCL group was aborted"):
        span.wait([_Pending()])
    assert given_up == [world]


# ----------------------------------------------------------- the processes
def _cli_argv(pkg: str, d: pathlib.Path, layout: str, i: int, coord: str) -> list[str]:
    n_proc = LAYOUTS[layout][0]
    dev = ["--backend", "cpu"] if pkg == "sdrreceiver_tpu" else ["--device", "cpu"]
    return [sys.executable, "-m", f"{pkg}.cli.main", "process-file", "-s",
            str(d / f"{layout}_h{i}.ini"), "--iq", str(d / "iq.u8"),
            "--out", str(d / f"{pkg}_{layout}_{i}"), *dev, "--mesh", layout,
            "--partition", "global", "--coordinator", coord, "--num-processes", str(n_proc),
            "--process-id", str(i)]


@pytest.fixture(scope="module")
def procs(tmp_path_factory):
    """Every step process's results (``CHILD``) per layout, their exit
    codes, stderr and the wall time, the plan and the blocks of each case;
    and both CLIs' ``process-file`` runs of each layout, all started at
    once."""
    from sdrreceiver_tpu_torch.io import iqfile

    d = tmp_path_factory.mktemp("anylayout")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        plan = build_plan(benchmark_config())
    raw = {lay: {case: _raw(plan, block) for case, block in CASES[lay].items()} for lay in LAYOUTS}
    for lay in LAYOUTS:
        torch.save({case: torch.from_numpy(r) for case, r in raw[lay].items()},
                   d / f"{lay}_blocks.pt")
    iq = iqfile.synthesize_channels(
        384000, 1536000, 1545600000,
        [(1545005146, 1000.0, 0.25), (1545214573, 750.0, 0.25), (1546005300, 1200.0, 0.25)],
        noise=0.01, dc_offset=0.02 + 0.01j,
    )
    iqfile.write_iq(d / "iq.u8", iq, "u8")
    child = (CHILD.replace("HAZARDS", inspect.getsource(_HostHazards))
             .replace("KBURST", str(K)).replace("TRANSPORTS", repr(TRANSPORTS)))
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    keys, argvs, envs = [], [], []
    for lay, (n_proc, n_local, _, n_chan) in LAYOUTS.items():
        coord = f"127.0.0.1:{_free_port()}"
        for i in range(n_proc):
            keys.append(("step", lay, i))
            argvs.append([sys.executable, "-c", child, coord, str(i), str(n_proc), str(n_local),
                          str(n_chan), str(d / f"{lay}_blocks.pt"), str(d / f"{lay}_p{i}.pt")])
            envs.append(env)
            (d / f"{lay}_h{i}.ini").write_text(INI_TMPL.format(port=_free_port()))
        for pkg, e in (("sdrreceiver_tpu_torch", env), ("sdrreceiver_tpu", _env(n_local))):
            coord = f"127.0.0.1:{_free_port()}"
            for i in range(n_proc):
                keys.append((pkg, lay, i))
                argvs.append(_cli_argv(pkg, d, lay, i, coord))
                envs.append(dict(e, OMP_NUM_THREADS="2"))
    t0 = time.perf_counter()
    ps = [subprocess.Popen(a, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=e,
                           cwd=str(REPO)) for a, e in zip(argvs, envs)]
    try:
        outs = [p.communicate(timeout=max(LIMIT - (time.perf_counter() - t0), 1)) for p in ps]
    finally:
        for p in ps:
            if p.poll() is None:
                p.kill()
    secs = time.perf_counter() - t0
    run = {k: (p.returncode, so, se) for k, p, (so, se) in zip(keys, ps, outs)}
    res = {}
    for (kind, lay, i), (rc, so, se) in run.items():
        if kind == "step":
            assert "saved" in so, f"{lay} process {i} exited {rc}: {se[-3000:]}"
            res[lay, i] = torch.load(d / f"{lay}_p{i}.pt", weights_only=False)
    return {"res": res, "run": run, "secs": secs, "plan": plan, "raw": raw, "dir": d}


# ------------------------------ 2. eager, body and burst, on both transports
@pytest.mark.parametrize("transport", TRANSPORTS)
@pytest.mark.parametrize("case", ["flagship", "short"])
@pytest.mark.parametrize("layout, pid", PIDS)
def test_body_and_burst_equal_eager(procs, layout, pid, case, transport):
    r = procs["res"][layout, pid][case, transport]
    _equal(r["body"], r["eager"], "body outputs vs eager")
    _equal(r["body_states"], r["eager_states"], "body state vs eager")
    _equal(r["burst"], r["eager"][:K], "burst outputs vs eager")
    _equal([r["burst_state"]], r["eager_states"][K - 1:K], "burst state vs eager")
    other = procs["res"][layout, pid][case, "staged"]
    _equal(r["eager"], other["eager"], "vs the staged transport")


# ---------------------- 3. each process its own shards and ranges only
@pytest.mark.parametrize("layout, case", STEPS)
def test_each_process_computes_its_shards_and_ranges_once(procs, layout, case):
    """Each process computes the time shards of its rows (a per-shard
    front a shard and step where the block gives the kernels their
    warm-up: p1 of the 2x3 two; none at 2,048, the stateful cascade) and
    exactly the channel ranges the tables give it; over the processes
    every range of the 11- and 15-channel buckets is computed once."""
    plan = procs["plan"]
    n_proc, _, n_time, n_chan = LAYOUTS[layout]
    fronts = len(ShardedReceiver(plan, (n_time, n_chan), CASES[layout][case],
                                 device="cpu")._fronts)
    assert fronts == (0 if CASES[layout][case] == 2048 else 1)
    split = {f"g{g.index}/b{bi}": b.channels for g in plan.groups
             for bi, b in enumerate(g.buckets) if b.channels >= n_chan}
    assert sorted(split.values()) == [11, 15]
    total = dict.fromkeys(split, 0)
    for pid in range(n_proc):
        res = procs["res"][layout, pid]
        r = res[case, "collective"]
        rows = TABLES[layout][pid][0]
        assert res["layout"]["rows"] == r["shards"] == rows
        assert res["layout"]["ranks"] == RANKS[layout]
        assert r["fronts"] == len(rows) * fronts
        ranges = [j for j, _ in TABLES[layout][pid][-1]]
        want = {}
        for bk, c in split.items():
            parts = r["parts"][bk]
            assert [hi - lo for lo, hi, _ in parts] == [len(x) for x in
                                                        np.array_split(np.arange(c), n_chan)]
            assert [j for j, (_, _, mine) in enumerate(parts) if mine] == ranges
            want[bk] = sum(parts[j][1] - parts[j][0] for j in ranges)
            total[bk] += want[bk]
        assert r["computed"] == want
    assert total == split


# ----------------------------------- 4. no host exchange, no host hazard
@pytest.mark.parametrize("case", ["flagship", "short"])
@pytest.mark.parametrize("layout, pid", PIDS)
def test_collective_body_has_no_host_exchange_sync_or_upload(procs, layout, pid, case):
    col = procs["res"][layout, pid][case, "collective"]
    staged = procs["res"][layout, pid][case, "staged"]
    # the same exchanges, none through the host: the time exchanges among
    # every process (the time group is the world) and one channel exchange
    # a split bucket
    assert col["per_step"]["hosts"] == [] and staged["per_step"]["collectives"] == []
    kinds = col["per_step"]["collectives"]
    assert kinds == staged["per_step"]["hosts"]
    assert kinds.count("chan") == 2 and {"halo", "gather"} <= set(kinds)
    assert col["hazards"] == [] and staged["hazards"] == []


# -------------------------------------- 5. the processes vs one process's mesh
@pytest.mark.parametrize("layout, case", STEPS)
def test_union_equals_one_process_mesh(procs, layout, case):
    n_proc, _, n_time, n_chan = LAYOUTS[layout]
    rx = ShardedReceiver(procs["plan"], (n_time, n_chan), CASES[layout][case], device="cpu")
    s, ref = rx.init_state(), []
    for b in torch.from_numpy(procs["raw"][layout][case]):
        s, o = rx.step_u8(s, b)
        ref.append({k: v.numpy() for k, v in o.items()})
    ref_state = rx.export_state(s)
    for pid in range(n_proc):  # every process holds every output and the whole state
        r = procs["res"][layout, pid][case, "collective"]
        _equal(r["eager"], ref, f"process {pid}")
        _equal([r["eager_states"][-1]], [ref_state], f"process {pid} state")
    owner = multihost.output_key_owner(rx.plan, n_proc)
    union = [{k: procs["res"][layout, multihost.key_owner(owner, k) or 0][case,
                                                                          "collective"]["body"][i][k]
              for k in o} for i, o in enumerate(ref)]
    _equal(union, ref, "union")


# ----------------------------------------------- 6. the processes vs JAX's mesh
@pytest.mark.parametrize("ref", ["pallas", "jnp"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_matches_jax_sharded(procs, layout, ref):
    n_proc, _, n_time, n_chan = LAYOUTS[layout]
    raw = procs["raw"][layout]["flagship"]
    rx = ShardedReceiver(procs["plan"], (n_time, n_chan), CASES[layout]["flagship"], device="cpu")
    pallas = ref == "pallas"
    jrx = JShardedReceiver(jbuild_plan(graft._benchmark_config()),
                           jmake_mesh(n_time=n_time, n_chan=n_chan,
                                      devices=jax.devices()[:n_time * n_chan]),
                           CASES[layout]["flagship"], use_pallas=pallas, pallas_interpret=pallas)
    js, jo = jrx.step_many_u8(jrx.init_state(), jnp.asarray(raw))
    theirs = [jrx.split_audio({k: np.asarray(v) for k, v in x.items()})
              for x in jrx.unstack_outputs(jo, N_BLOCKS)]
    for pid in range(n_proc):
        body = procs["res"][layout, pid]["flagship", "collective"]["body"]
        _assert_audio_close([rx.split_audio(o) for o in body], theirs)
    a, b = procs["res"][layout, n_proc - 1]["flagship", "collective"]["body_states"][-1], \
        jrx.export_state(js)
    assert a.keys() == b.keys()
    for k, v in b.items():
        assert a[k].shape == v.shape and a[k].dtype == v.dtype, k
        if v.dtype == np.uint32:
            np.testing.assert_array_equal(a[k], v, err_msg=k)
        else:
            np.testing.assert_allclose(a[k], v, rtol=0, atol=1e-3, err_msg=k)


# ------------------------------------------------------------ 7. the CLIs
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_cli_global_matches_jax_cli(procs, layout):
    """``process-file --mesh LAYOUT --partition global`` over its
    processes: both CLIs' processes exit 0, each writes the topics it owns
    (none where there are more processes than groups), the port's union
    has the JAX CLI's files, within 1 LSB, and the summaries' ``multihost``
    blocks are equal."""
    n_proc, _, n_time, _ = LAYOUTS[layout]
    d, run = procs["dir"], procs["run"]
    sums = {}
    for pkg in ("sdrreceiver_tpu_torch", "sdrreceiver_tpu"):
        for i in range(n_proc):
            rc, so, se = run[pkg, layout, i]
            assert rc == 0, f"{pkg} CLI process {i} exited {rc}: {se[-3000:]}"
        sums[pkg] = [json.loads(run[pkg, layout, i][1].strip().splitlines()[-1])
                     for i in range(n_proc)]
    ports, jaxs = sums["sdrreceiver_tpu_torch"], sums["sdrreceiver_tpu"]
    blocks = [[{k: v for k, v in s["multihost"].items() if k != "coordinator"} for s in ss]
              for ss in (ports, jaxs)]
    assert blocks[0] == blocks[1]
    assert [(s["multihost"]["mode"], s["multihost"]["report"]["n_time"],
             s["multihost"]["report"]["n_hosts"]) for s in ports] == [("global", n_time,
                                                                       n_proc)] * n_proc
    assert [s["exchange"] for s in ports] == ["gloo"] * n_proc
    files = {}
    for pkg in sums:
        parts = [{p.name: np.fromfile(p, np.int16)
                  for p in (d / f"{pkg}_{layout}_{i}").glob("audio_*.s16")} for i in range(n_proc)]
        for i, s in enumerate(sums[pkg]):
            assert set(parts[i]) == {f"audio_{t}.s16" for t in s["multihost"]["local_topics"]}
        assert sum(len(p) for p in parts) == len({k for p in parts for k in p}) == 3, pkg
        files[pkg] = {k: v for p in parts for k, v in p.items()}
    ours, theirs = files["sdrreceiver_tpu_torch"], files["sdrreceiver_tpu"]
    assert ours.keys() == theirs.keys()
    _assert_audio_close([ours], [theirs])


# ----------------------------------------------------- 8. a peer that is gone
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_without_its_peer_raises_and_exits_nonzero(procs, layout):
    """The last process leaves after its results; the others step on:
    their next exchange raises, the error is not swallowed, and each exits
    non-zero, well within the module's limit."""
    n_proc = LAYOUTS[layout][0]
    run = procs["run"]
    assert run["step", layout, n_proc - 1][0] == 0
    for i in range(n_proc - 1):
        rc, so, se = run["step", layout, i]
        assert rc != 0 and "stepped without its peer" not in so
        assert "in communicate" in se, se[-2000:]
    assert procs["secs"] < LIMIT
