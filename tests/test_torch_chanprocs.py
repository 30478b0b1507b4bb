"""The port's channel axis across processes on the CPU: a ``--partition
global`` mesh whose time rows span processes (``dist/mesh.py``,
``dist/multihost.py``, ``dist/sharded.py``).

The JAX package's ``global_mesh`` lays every process's devices out in
process order, in rows of ``n_chan``: with one device a process and
``n_chan = 2`` a time row holds two processes, and its SPMD step splits
each bucket's channels between them.  The port does the same: each process
computes the time shards of its row whole and only the channel ranges of
its own devices; one ``"chan"`` exchange a split bucket gathers the other
ranges.  Two processes join a gloo group and build one global 1x2 mesh (one
CPU device each).  Each runs, on the same 3 u8 blocks, the eager step, the
``MeshGraphs`` body and a burst of k = 2, with the exchanges as collectives
(what distinct cards capture inside their graphs) and staged (gloo on host
buffers, one card or the CPU); the flagship plan at block 49,152 (the
per-shard mix-cascade; buckets of 1 channel whole, of 11 and 15 split 6/5
and 8/7) and at 2048 (the stateful cascade).  The processes start once for
the module, with the two CLIs' runs of one ``process-file --mesh 1x2
--partition global``.  The parent holds:

1. as plain cases: ``global_mesh``'s layout against the JAX package's, and
   the columns, rows, exchange groups, ``prev``, ``next`` and ``last`` of
   every process of a 2x2 over four processes;
2. the eager step, the body and the burst bit-equal, on both transports;
3. each process computing only its own channel ranges of a split bucket;
4. no host exchange, sync or upload in the collective body;
5. the union of the topics each process publishes bit-equal to the
   one-process 1x2 mesh;
6. within 1 LSB (flip rate < 1e-3) of the JAX package's ``ShardedReceiver``
   on a 1x2 mesh of two virtual CPU devices, Pallas interpret and jnp;
7. the CLI run: both processes exit 0, each writes its own topics, and the
   union is within 1 LSB of the JAX CLI's same run;
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
from sdrreceiver_tpu_torch.io.iqfile import synthesize_channels, to_u8
from test_multihost_proc import INI_TMPL, _env
from test_torch_cli import _free_port
from test_torch_graphs import _HostHazards
from test_torch_receiver import _assert_audio_close

# six xdist workers share the machine's cores: a few torch threads each
torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
N_BLOCKS = 3
K = 2
#: name -> block (the flagship plan on a global 1x2 mesh)
CASES = {"flagship": 49152, "stateful": 2048}
TRANSPORTS = ("collective", "staged")
#: seconds the processes may take together
LIMIT = 120

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

def main(coord, pid, data, out):
    multihost.TIMEOUT_S = 60
    multihost.initialize(coord, 2, pid)
    mesh = multihost.global_mesh(2, ["cpu"])
    hz = _HostHazards()
    for cls in (DcIngest, MixCascade):
        def inside(*args, _orig=cls.forward):
            hz.inside += 1
            try:
                return _orig(*args)
            finally:
                hz.inside -= 1
        cls.forward = inside
    plan = build_plan(benchmark_config())
    res = {"layout": {"rows": mesh.rows(), "columns": mesh.columns(), "home": str(mesh.home),
                      "ranks": mesh.ranks}}
    for case, blocks in torch.load(data).items():
        for transport in TRANSPORTS:
            rx = ShardedReceiver(plan, mesh, blocks.shape[1] // 2)
            rx._span = multihost.ProcessSpan(mesh, transport=transport)
            r = res[case, transport] = {"eager": [], "eager_states": [],
                                        "parts": {k: [(lo, hi, p is not None) for lo, hi, _, p in v]
                                                  for k, v in rx._chan_parts.items()}}
            s = rx.init_state()
            for i, b in enumerate(blocks):
                computed.clear()
                s, o = rx.step_u8(s, b)
                r["eager"].append(host(o))
                r["eager_states"].append(rx.export_state(s))
            r["computed"] = dict(computed)
            graphs = MeshGraphs(rx)
            run(graphs, rx, blocks, hz, r)
            r["hazards"] = list(hz.found)
            hz.found.clear()
            res["graphs"] = graphs, blocks
    graphs, blocks = res.pop("graphs")
    torch.save(res, out)
    print("saved", flush=True)
    if pid == 1:
        return 0  # the peer goes: process 0's next exchange must fail
    s = graphs.state
    for i in range(50):
        s, _ = graphs.step(s, blocks[i % len(blocks)])
    print("stepped without its peer", flush=True)
    return 0

sys.exit(main(sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]))
'''


# --------------------------------------------------- 1. plain: the layout
@pytest.mark.parametrize("n_proc, n_chan", [(2, 2), (4, 2)], ids=["2x1 at 2", "4x1 at 2"])
def test_global_mesh_layout_equals_jax(monkeypatch, n_proc, n_chan):
    """Each position (row, column, owning process) of the port's global
    mesh over ``n_proc`` processes of one device each equals the JAX
    package's ``global_mesh`` over ``n_proc`` devices in process order."""
    devs = jax.devices()[:n_proc]
    jm = jmultihost.global_mesh(n_chan, devs)
    theirs = [[devs.index(d) for d in row] for row in jm.devices]
    for pid in range(n_proc):
        class _Dist:  # each process's one device, gathered
            def all_gather_object(self, out, mine):
                out[:] = [mine] * n_proc

        monkeypatch.setattr(multihost, "initialize", lambda: (pid, n_proc))
        monkeypatch.setattr(multihost, "_dist", _Dist)
        mesh = multihost.global_mesh(n_chan, ["cpu"])
        assert mesh.shape == {TIME_AXIS: n_proc // n_chan, CHAN_AXIS: n_chan} == dict(jm.shape)
        assert mesh.ranks == theirs and mesh.rank == pid
        (row,) = [i for i, r in enumerate(theirs) if pid in r]
        assert mesh.rows() == [row] and mesh.columns() == [theirs[row].index(pid)]
        assert mesh.home == mesh.local()[0] == torch.device("cpu") and len(mesh.local()) == 1


def test_global_mesh_refuses_what_it_cannot_split():
    """A layout whose process's devices end one time row and begin the next
    (3 processes of 2 devices at n_chan=3) builds, with its owner tables:
    one time group and one channel group of every process, each time shard
    published by the last of its row's processes, each channel range
    computed by one process at its first position.  Rows that are no
    contiguous run of positions, which no ``global_mesh`` produces, are
    refused."""
    for pid, rows in enumerate([[0], [0, 1], [1]]):
        mesh = Mesh([["cpu"] * 3] * 2, [[0, 0, 1], [1, 2, 2]], rank=pid)
        assert mesh.rows() == rows
        assert mesh.partition(TIME_AXIS) == mesh.partition(CHAN_AXIS) == [[0, 1, 2]]
        assert mesh.publishers() == [1, 2]
        assert mesh.chan_owners() == [(0, 0), (2, 1), (1, 0)]
    with pytest.raises(ValueError, match="contiguous"):
        Mesh([["cpu"], ["cpu"], ["cpu"]], [[0], [1], [0]], rank=0)


class _Groups:
    """A process group that records each ``new_group`` call."""

    def __init__(self):
        self.calls = []

    def new_group(self, ranks=None, backend=None, timeout=None):
        self.calls.append((backend, None if ranks is None else tuple(ranks)))
        return f"{backend}{'world' if ranks is None else tuple(ranks)}"


def test_span_groups_of_a_2x2_over_four_processes(monkeypatch):
    """Every process of a global 2x2 (one device each): its column (time
    neighbours), row (channel split), ``prev``/``next``/``last``, and its
    groups: every process makes every group of both axes, in one order,
    and gets those of its own column and row."""
    for pid in range(4):
        fake = _Groups()
        monkeypatch.setattr(multihost, "_groups", {})
        monkeypatch.setattr(multihost, "_dist", lambda: fake)
        mesh = Mesh([["cpu", "cpu"], ["cpu", "cpu"]], [[0, 1], [2, 3]], rank=pid)
        span = multihost.ProcessSpan(mesh, transport="collective")
        col, row = pid % 2, pid // 2
        assert span.column == mesh.column_ranks() == [col, col + 2]
        assert span.row == mesh.row_ranks() == [2 * row, 2 * row + 1]
        assert (span.lo, span.hi, span.n, span.time, span.world) == (row, row + 1, 2, True, 2)
        assert span.prev == (pid - 2 if row else None) and span.next == (None if row else pid + 2)
        assert span.last == col + 2
        assert mesh.partition(TIME_AXIS) == [[0, 2], [1, 3]]
        assert mesh.partition(CHAN_AXIS) == [[0, 1], [2, 3]]
        assert span.backend == "gloo"
        assert (span.group, span.row_group) == (f"gloo{(col, col + 2)}",
                                                f"gloo{(2 * row, 2 * row + 1)}")
        assert fake.calls == [("gloo", (0, 2)), ("gloo", (1, 3)), ("gloo", (0, 1)), ("gloo", (2, 3))]
        # NCCL (distinct cards): the same groups, and the world's a group of its own
        fake.calls.clear()
        made = [multihost._exchange_groups(mesh.partition(ax), "nccl", [0, 1, 2, 3])
                for ax in (TIME_AXIS, CHAN_AXIS, TIME_AXIS)]
        assert made[0] == made[2] == {(0, 2): "nccl(0, 2)", (1, 3): "nccl(1, 3)"}
        assert made[1] == {(0, 1): "nccl(0, 1)", (2, 3): "nccl(2, 3)"}
        assert multihost._exchange_groups([[0, 1, 2, 3]], "nccl", [0, 1, 2, 3]) == {
            (0, 1, 2, 3): "ncclworld"}
        # each made once per process group
        assert fake.calls == [("nccl", (0, 2)), ("nccl", (1, 3)), ("nccl", (0, 1)),
                              ("nccl", (2, 3)), ("nccl", None)]


def test_span_of_whole_rows_and_of_a_row_alone():
    """Whole rows a process (the global 2x1): the column is every process,
    no row group, as before.  A 1x2 of two processes: no time exchange
    (the column is this process alone), the row is both."""
    span = multihost.ProcessSpan(Mesh([["cpu"], ["cpu"]], [[0], [1]], rank=1))
    assert (span.column, span.row, span.time, span.prev, span.last) == ([0, 1], [1], True, 0, 1)
    assert span.group is None and span.row_group is None
    span = multihost.ProcessSpan(Mesh([["cpu", "cpu"]], [[0, 1]], rank=1))
    assert (span.column, span.row, span.time, span.prev, span.next) == ([1], [0, 1], False, None,
                                                                      None)
    assert span.group is None and span.row_group is None  # the default group of both
    send, recv = span.buffers("chan", torch.ones(1, 5, dtype=torch.uint8))
    assert send.shape == (1, 5) and recv.shape == (2, 5)


@pytest.mark.parametrize("counts", [[6, 5], [8, 7], [3, 3, 2, 2]], ids=["11/2", "15/2", "10/4"])
def test_chan_pack_round_trips(counts):
    """The channel exchange's rows: each range's items (int16 audio of an
    odd length, int64 phases, planar float32 histories) padded to the
    largest range, packed into one row of bytes each, cut back after the
    gather: the concatenation of every range, bit for bit, each item's
    bytes aligned for its dtype."""
    rng = np.random.default_rng(3)
    m = max(counts)
    ranges = [[torch.from_numpy(rng.integers(-2**15, 2**15, (c, 3)).astype(np.int16)),
               torch.from_numpy(rng.integers(0, 2**40, (c,))),
               torch.from_numpy(rng.standard_normal((c, 2, 5)).astype(np.float32))]
              for c in counts]
    rows = torch.stack([sharded._pack(items, m) for items in ranges])
    assert rows.dtype == torch.uint8 and rows.shape[1] % 8 == 0
    full = sharded._unpack(rows, ranges[0], counts, m)
    for k, t in enumerate(full):
        want = torch.cat([items[k] for items in ranges])
        assert t.dtype == want.dtype and torch.equal(t, want), k


# ----------------------------------------------------------- the processes
def _raw(plan, block: int) -> np.ndarray:
    """[N_BLOCKS, 2*block] u8: a USB tone in every sub-VFO, noise, a DC
    offset (seeded)."""
    subs = [s for g in plan.groups for b in g.buckets for s in b.subs]
    iq = synthesize_channels(
        N_BLOCKS * block, plan.fs, plan.center_frequency,
        [(s.frequency, 700 + 37 * i, 1.0) for i, s in enumerate(subs)],
        noise=0.5, dc_offset=2 - 1j, seed=11,
    )
    return to_u8(iq).reshape(N_BLOCKS, 2 * block)


def _cli_argv(pkg: str, d: pathlib.Path, i: int, coord: str) -> list[str]:
    dev = ["--backend", "cpu"] if pkg == "sdrreceiver_tpu" else ["--device", "cpu"]
    return [sys.executable, "-m", f"{pkg}.cli.main", "process-file", "-s", str(d / f"h{i}.ini"),
            "--iq", str(d / "iq.u8"), "--out", str(d / f"{pkg}{i}"), *dev, "--mesh", "1x2",
            "--partition", "global", "--coordinator", coord, "--num-processes", "2",
            "--process-id", str(i)]


@pytest.fixture(scope="module")
def procs(tmp_path_factory):
    """Both step processes' results (``CHILD``), their exit codes, stderr
    and wall time, the plan and the blocks of each case; and the two CLIs'
    ``process-file`` runs (two processes each), all started at once."""
    from sdrreceiver_tpu_torch.io import iqfile

    d = tmp_path_factory.mktemp("chanprocs")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        plan = build_plan(benchmark_config())
    raw = {case: _raw(plan, block) for case, block in CASES.items()}
    torch.save({case: torch.from_numpy(r) for case, r in raw.items()}, d / "blocks.pt")
    iq = iqfile.synthesize_channels(
        384000, 1536000, 1545600000,
        [(1545005146, 1000.0, 0.25), (1545214573, 750.0, 0.25), (1546005300, 1200.0, 0.25)],
        noise=0.01, dc_offset=0.02 + 0.01j,
    )
    iqfile.write_iq(d / "iq.u8", iq, "u8")
    for i in (0, 1):
        (d / f"h{i}.ini").write_text(INI_TMPL.format(port=_free_port()))
    child = (CHILD.replace("HAZARDS", inspect.getsource(_HostHazards))
             .replace("KBURST", str(K)).replace("TRANSPORTS", repr(TRANSPORTS)))
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    coord = f"127.0.0.1:{_free_port()}"
    argvs = [[sys.executable, "-c", child, coord, str(i), str(d / "blocks.pt"),
              str(d / f"p{i}.pt")] for i in (0, 1)]
    envs = [env, env]
    for pkg, e in (("sdrreceiver_tpu_torch", env), ("sdrreceiver_tpu", _env(1))):
        coord = f"127.0.0.1:{_free_port()}"
        argvs += [_cli_argv(pkg, d, i, coord) for i in (0, 1)]
        envs += [dict(e, OMP_NUM_THREADS="2"), dict(e, OMP_NUM_THREADS="2")]
    t0 = time.perf_counter()
    ps = [subprocess.Popen(a, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=e,
                           cwd=str(REPO)) for a, e in zip(argvs, envs)]
    try:
        outs = [p.communicate(timeout=LIMIT) for p in ps]
    finally:
        for p in ps:
            if p.poll() is None:
                p.kill()
    secs = time.perf_counter() - t0
    for i, (so, se) in enumerate(outs[:2]):
        assert "saved" in so, f"process {i} exited {ps[i].returncode}: {se[-3000:]}"
    res = [torch.load(d / f"p{i}.pt", weights_only=False) for i in (0, 1)]
    return {"res": res, "rcs": [p.returncode for p in ps], "out": outs, "secs": secs,
            "plan": plan, "raw": raw, "dir": d}


def _equal(ours: list[dict], ref: list[dict], what):
    assert len(ours) == len(ref), what
    for i, (a, b) in enumerate(zip(ours, ref)):
        assert a.keys() == b.keys(), (what, i)
        for k in b:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (what, i, k)


# ------------------------------ 2. eager, body and burst, on both transports
@pytest.mark.parametrize("transport", TRANSPORTS)
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("pid", [0, 1])
def test_body_and_burst_equal_eager(procs, pid, case, transport):
    r = procs["res"][pid][case, transport]
    _equal(r["body"], r["eager"], "body outputs vs eager")
    _equal(r["body_states"], r["eager_states"], "body state vs eager")
    _equal(r["burst"], r["eager"][:K], "burst outputs vs eager")
    _equal([r["burst_state"]], r["eager_states"][K - 1:K], "burst state vs eager")
    other = procs["res"][pid][case, "staged"]
    _equal(r["eager"], other["eager"], "vs the staged transport")


# ------------------------------------- 3. each process its own channels only
@pytest.mark.parametrize("case", sorted(CASES))
def test_each_process_computes_only_its_channel_ranges(procs, case):
    """On the flagship the 11- and 15-channel buckets split 6/5 and 8/7
    over the row; process 0 holds the first range of each, process 1 the
    second, and each step's split bucket steps computed exactly those
    channels, 26 of them between the two processes, none twice."""
    plan = procs["plan"]
    split = {f"g{g.index}/b{bi}": b.channels for g in plan.groups
             for bi, b in enumerate(g.buckets) if b.channels >= 2}
    assert sorted(split.values()) == [11, 15]
    layout = [procs["res"][p]["layout"] for p in (0, 1)]
    assert [x["ranks"] for x in layout] == [[[0, 1]], [[0, 1]]]
    assert [(x["rows"], x["columns"]) for x in layout] == [([0], [0]), ([0], [1])]
    for pid in (0, 1):
        r = procs["res"][pid][case, "collective"]
        want = {}
        for bk, c in split.items():
            ranges = [(lo, hi) for lo, hi, _ in r["parts"][bk]]
            assert [hi - lo for lo, hi in ranges] == [-(-c // 2), c // 2]
            assert [mine for _, _, mine in r["parts"][bk]] == [pid == 0, pid == 1]
            want[bk] = ranges[pid][1] - ranges[pid][0]
        assert r["computed"] == want
    both = [procs["res"][p][case, "collective"]["computed"] for p in (0, 1)]
    assert {bk: both[0][bk] + both[1][bk] for bk in split} == split


# ----------------------------------- 4. no host exchange, no host hazard
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("pid", [0, 1])
def test_collective_body_has_no_host_exchange_sync_or_upload(procs, pid, case):
    col = procs["res"][pid][case, "collective"]
    staged = procs["res"][pid][case, "staged"]
    # the same exchanges, none through the host: one channel exchange a
    # split bucket, and no time exchange (the column is this process alone)
    assert col["per_step"]["hosts"] == [] and staged["per_step"]["collectives"] == []
    assert col["per_step"]["collectives"] == staged["per_step"]["hosts"] == ["chan", "chan"]
    assert col["hazards"] == [] and staged["hazards"] == []


# -------------------------------------- 5. the processes vs one process's mesh
@pytest.mark.parametrize("case", sorted(CASES))
def test_union_equals_one_process_mesh(procs, case):
    rx = ShardedReceiver(procs["plan"], (1, 2), CASES[case], device="cpu")
    s, ref = rx.init_state(), []
    for b in torch.from_numpy(procs["raw"][case]):
        s, o = rx.step_u8(s, b)
        ref.append({k: v.numpy() for k, v in o.items()})
    ref_state = rx.export_state(s)
    for pid in (0, 1):  # every process holds every output and the whole state
        r = procs["res"][pid][case, "collective"]
        _equal(r["eager"], ref, f"process {pid}")
        _equal([r["eager_states"][-1]], [ref_state], f"process {pid} state")
    owner = multihost.output_key_owner(rx.plan, 2)
    assert {multihost.key_owner(owner, k) for k in ref[0]} == {0, 1}
    union = [{k: procs["res"][multihost.key_owner(owner, k) or 0][case, "collective"]["body"][i][k]
              for k in o} for i, o in enumerate(ref)]
    _equal(union, ref, "union")


# ----------------------------------------------- 6. the processes vs JAX's mesh
@pytest.mark.parametrize("ref", ["pallas", "jnp"])
def test_matches_jax_sharded_1x2(procs, ref):
    raw = procs["raw"]["flagship"]
    rx = ShardedReceiver(procs["plan"], (1, 2), CASES["flagship"], device="cpu")
    pallas = ref == "pallas"
    jrx = JShardedReceiver(jbuild_plan(graft._benchmark_config()),
                           jmake_mesh(n_time=1, n_chan=2, devices=jax.devices()[:2]),
                           CASES["flagship"], use_pallas=pallas, pallas_interpret=pallas)
    js, jo = jrx.step_many_u8(jrx.init_state(), jnp.asarray(raw))
    theirs = [jrx.split_audio({k: np.asarray(v) for k, v in x.items()})
              for x in jrx.unstack_outputs(jo, N_BLOCKS)]
    for pid in (0, 1):
        ours = [rx.split_audio(o) for o in procs["res"][pid]["flagship", "collective"]["body"]]
        _assert_audio_close(ours, theirs)
    a, b = procs["res"][1]["flagship", "collective"]["body_states"][-1], jrx.export_state(js)
    assert a.keys() == b.keys()
    for k, v in b.items():
        assert a[k].shape == v.shape and a[k].dtype == v.dtype, k
        if v.dtype == np.uint32:
            np.testing.assert_array_equal(a[k], v, err_msg=k)
        else:
            np.testing.assert_allclose(a[k], v, rtol=0, atol=1e-3, err_msg=k)


# ------------------------------------------------------------ 7. the CLIs
def test_cli_global_1x2_matches_jax_cli(procs):
    """``process-file --mesh 1x2 --partition global`` over two processes:
    both CLIs' processes exit 0, each writes the topics it owns, the port's
    union has the JAX CLI's files, within 1 LSB."""
    d = procs["dir"]
    rcs, outs = procs["rcs"][2:], procs["out"][2:]
    for i, (rc, (so, se)) in enumerate(zip(rcs, outs)):
        assert rc == 0, f"CLI process {i} exited {rc}: {se[-3000:]}"
    ports = [json.loads(so.strip().splitlines()[-1]) for so, _ in outs[:2]]
    assert [s["multihost"]["mode"] for s in ports] == ["global", "global"]
    assert [s["multihost"]["report"]["n_time"] for s in ports] == [1, 1]
    assert [s["exchange"] for s in ports] == ["gloo", "gloo"]
    files = {}
    for pkg in ("sdrreceiver_tpu_torch", "sdrreceiver_tpu"):
        parts = [{p.name: np.fromfile(p, np.int16) for p in (d / f"{pkg}{i}").glob("audio_*.s16")}
                 for i in (0, 1)]
        assert parts[0] and parts[1] and not set(parts[0]) & set(parts[1]), pkg
        files[pkg] = {**parts[0], **parts[1]}
    for i, s in enumerate(ports):
        assert {f"audio_{t}.s16" for t in s["multihost"]["local_topics"]} == \
            {p.name for p in (d / f"sdrreceiver_tpu_torch{i}").glob("audio_*.s16")}
    ours, theirs = files["sdrreceiver_tpu_torch"], files["sdrreceiver_tpu"]
    assert ours.keys() == theirs.keys() and len(ours) == 3
    _assert_audio_close([ours], [theirs])


# ----------------------------------------------------- 8. a peer that is gone
def test_without_its_peer_raises_and_exits_nonzero(procs):
    """Process 1 leaves after its results; process 0 steps on: its next
    channel exchange raises, the error is not swallowed, and the process
    exits non-zero, well within the module's limit."""
    (so0, se0), _ = procs["out"][:2]
    assert procs["rcs"][1] == 0
    assert procs["rcs"][0] != 0 and "stepped without its peer" not in so0
    assert "in communicate" in se0, se0[-2000:]
    assert procs["secs"] < LIMIT
