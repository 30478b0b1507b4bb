"""The port's exchanges across processes as collectives (``ProcessSpan``'s
``"collective"`` transport, ``dist/multihost.py``; ``dist/meshgraph.py``)
on the CPU.

On distinct cards a ``--partition global`` mesh exchanges through NCCL
collectives on the card tensors, captured inside the phase graphs.  This
machine has no NCCL, so the same collective calls run on gloo on the CPU
tensors themselves (``ProcessSpan(mesh, transport="collective")``, a
keyword only tests pass), with no host staging.  Two processes join a gloo
group and build one global 2x1 mesh (one CPU shard each).  Each runs, on
the same 3 u8 blocks, the eager step with collective exchanges, the
``MeshGraphs`` body with collective exchanges (what the card captures: no
exchange is a phase boundary) and the body with staged exchanges (gloo
on host buffers, the CPU default), 3 single steps and one burst of k = 2; the
flagship plan at block 49,152 (the per-shard mix-cascade) and at 2048 (the
stateful cascade, whose histories come from the last shard's process).
The processes start once for the module; the parent holds:

1. the transport rule as plain cases (:func:`multihost.exchange_backend`),
   the span's transports, and the bounded wait at a replay's end;
2. the collective body bit-equal to the staged body and to the eager
   step, outputs and exported state; the burst bit-equal to single steps;
3. no host exchange in the collective body, and no host synchronisation
   or host upload anywhere in it (the hazard check of
   ``test_torch_graphs.py``, with no exemption for the exchanges);
4. the union of the topics each process publishes bit-equal to the
   one-process 2x1 mesh;
5. within 1 LSB (flip rate < 1e-3) of the JAX package's
   ``ShardedReceiver`` 2x1 ``step_many_u8``, Pallas interpret and jnp;
6. a step whose peer has gone raises in the collective, and the process
   exits non-zero.
"""

import inspect
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
from sdrreceiver_tpu.graph import build_plan as jbuild_plan
from sdrreceiver_tpu_torch.dist import Mesh, ShardedReceiver, multihost
from sdrreceiver_tpu_torch.flagship import benchmark_config
from sdrreceiver_tpu_torch.graph.plan import build_plan
from sdrreceiver_tpu_torch.io.iqfile import synthesize_channels, to_u8
from test_torch_cli import _free_port
from test_torch_graphs import _HostHazards
from test_torch_receiver import _assert_audio_close

# six xdist workers share the machine's cores: a few torch threads each
torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
N_BLOCKS = 3
K = 2
#: name -> block (the flagship plan on a global 2x1 mesh)
CASES = {"flagship": 49152, "stateful": 2048}
#: seconds the two processes may take together
LIMIT = 120

CHILD = '''
import contextlib
import sys
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from sdrreceiver_tpu_torch.cuda.dckernel import DcIngest
from sdrreceiver_tpu_torch.cuda.frontend import MixCascade
from sdrreceiver_tpu_torch.dist import ShardedReceiver, multihost
from sdrreceiver_tpu_torch.dist.meshgraph import MeshGraphs
from sdrreceiver_tpu_torch.flagship import benchmark_config
from sdrreceiver_tpu_torch.graph.plan import build_plan

torch.set_num_threads(2)

HAZARDS

def host(o):
    return {k: v.numpy() for k, v in o.items()}

def run(graphs, rx, blocks, hz, r, name):
    """The body of ``graphs`` over the blocks (the first step builds its
    buffers; the others under the hazard check)."""
    r[name], r[name + "_states"] = [], []
    s = rx.init_state()
    for i, b in enumerate(blocks):
        with hz if i else contextlib.nullcontext():
            s, o = graphs.step(s, b)
        r[name].append(host(o))
        r[name + "_states"].append(rx.export_state(s))
    (entry,) = graphs._entries.values()
    t = entry.body.transfers
    r[name + "_per_step"] = {"transfers": t.calls, "exchanges": t.exchanges,
                             "hosts": [x.kind for x in t.hosts],
                             "collectives": [x.kind for x in t.collectives]}

def main(coord, pid, data, out):
    multihost.TIMEOUT_S = 60
    multihost.initialize(coord, 2, pid)
    mesh = multihost.global_mesh(1, ["cpu"])
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
    res = {}
    for case, blocks in torch.load(data).items():
        block = blocks.shape[1] // 2
        staged = ShardedReceiver(plan, mesh, block)
        rx = ShardedReceiver(plan, mesh, block)
        rx._span = multihost.ProcessSpan(mesh, transport="collective")
        r = res[case] = {"eager": [], "eager_states": [],
                         "transports": [(x._span.transport, x.exchange) for x in (rx, staged)]}
        s = rx.init_state()
        for b in blocks:
            s, o = rx.step_u8(s, b)
            r["eager"].append(host(o))
            r["eager_states"].append(rx.export_state(s))
        graphs = MeshGraphs(rx)
        run(graphs, rx, blocks, hz, r, "collective")
        r["hazards"] = list(hz.found)
        run(MeshGraphs(staged), staged, blocks, hz, r, "staged")
        hz.found.clear()
        graphs.step(rx.init_state(), blocks[:KBURST])  # builds the burst's buffers
        s = rx.init_state()
        with hz:
            s, many = graphs.step(s, blocks[:KBURST])
        r["burst"] = [host(o) for o in rx.unstack_outputs(many, KBURST)]
        r["burst_state"] = rx.export_state(s)
        burst = graphs._entries[(torch.uint8, tuple(blocks[:KBURST].shape))]
        r["burst_exchanges"] = burst.body.transfers.exchanges
        r["burst_hosts"] = len(burst.body.transfers.hosts)
        r["hazards"] += hz.found
        hz.found.clear()
        r["graphs"] = graphs
    torch.save({k: {n: v for n, v in r.items() if n != "graphs"} for k, r in res.items()}, out)
    print("saved", flush=True)
    if pid == 1:
        return 0  # the peer goes: process 0's next collective must fail
    graphs, blocks = res["flagship"]["graphs"], torch.load(data)["flagship"]
    s = graphs.state
    for i in range(50):
        s, _ = graphs.step(s, blocks[i % len(blocks)])
    print("stepped without its peer", flush=True)
    return 0

sys.exit(main(sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]))
'''


# ------------------------------------------------ 1. the rule and the span
@pytest.mark.parametrize("ids, backend", [
    ([["A"], ["A"]], "gloo"),  # one card shared by two processes
    ([["A"], ["B"]], "nccl"),  # a card a process
    ([["A", "B"], ["C", "D"]], "nccl"),  # two cards a process, all distinct
    ([["A", "B"], ["C", "A"]], "gloo"),  # one card of four held twice
    ([["A", "A"], ["B", "B"]], "nccl"),  # a card repeated within one process
    ([[None], [None]], "gloo"),  # CPU shards
], ids=["shared card", "card a process", "two cards a process", "one of four twice",
        "repeated in a process", "cpu"])
def test_exchange_backend(ids, backend):
    assert multihost.exchange_backend(ids) == backend


def test_span_transports_on_cpu():
    """On CPU shards the rule gives the staged gloo path; the collective
    transport is asked for by keyword and runs on gloo, with no group of
    its own; an unknown transport is refused."""
    mesh = Mesh([["cpu"], ["cpu"]], [[0], [1]], rank=0)
    span = multihost.ProcessSpan(mesh)
    assert (span.transport, span.backend, span.group) == ("staged", "gloo", None)
    assert span.exchange == span.eager and span.next == 1 and span.prev is None
    col = multihost.ProcessSpan(mesh, transport="collective")
    assert (col.transport, col.backend, col.group) == ("collective", "gloo", None)
    send, recv = col.buffers("gather", torch.ones(2, 3))
    assert send.device == recv.device == torch.device("cpu") and recv.shape == (4, 3)
    assert not recv.any()
    with pytest.raises(ValueError):
        multihost.ProcessSpan(mesh, transport="nccl")


class _Event:
    def __init__(self, done: bool):
        self.done = done

    def query(self) -> bool:
        return self.done


def test_replay_wait_is_bounded(monkeypatch):
    """A replay whose events never complete (a peer gone inside an NCCL
    kernel) gives the group up (aborted, the process set to end) and
    raises once the deadline passes."""
    assert multihost.await_events([_Event(True), _Event(True)], 0.1)
    t0 = time.monotonic()
    assert not multihost.await_events([_Event(True), _Event(False)], 0.2)
    assert 0.2 <= time.monotonic() - t0 < 5
    given_up = []
    monkeypatch.setattr(multihost, "TIMEOUT_S", 0.2)
    monkeypatch.setattr(multihost, "_give_up", given_up.append)
    span = multihost.ProcessSpan(Mesh([["cpu"], ["cpu"]], [[0], [1]], rank=1))
    span.group = "the group"
    span.wait([_Event(True)])
    assert given_up == []
    with pytest.raises(RuntimeError, match="NCCL group was aborted"):
        span.wait([_Event(False)])
    assert given_up == ["the group"]


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


@pytest.fixture(scope="module")
def procs(tmp_path_factory):
    """Both processes' results (``CHILD``), their exit codes, stderr and
    wall time, the plan and the blocks of each case."""
    d = tmp_path_factory.mktemp("collectives")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        plan = build_plan(benchmark_config())
    raw = {case: _raw(plan, block) for case, block in CASES.items()}
    torch.save({case: torch.from_numpy(r) for case, r in raw.items()}, d / "blocks.pt")
    child = CHILD.replace("HAZARDS", inspect.getsource(_HostHazards)).replace("KBURST", str(K))
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    t0 = time.perf_counter()
    ps = [subprocess.Popen([sys.executable, "-c", child, coord, str(i), str(d / "blocks.pt"),
                            str(d / f"p{i}.pt")], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True, env=env, cwd=str(REPO)) for i in (0, 1)]
    try:
        outs = [p.communicate(timeout=LIMIT) for p in ps]
    finally:
        for p in ps:
            if p.poll() is None:
                p.kill()
    secs = time.perf_counter() - t0
    for i, (so, se) in enumerate(outs):
        assert "saved" in so, f"process {i} exited {ps[i].returncode}: {se[-3000:]}"
    res = [torch.load(d / f"p{i}.pt", weights_only=False) for i in (0, 1)]
    return {"res": res, "rcs": [p.returncode for p in ps], "out": outs, "secs": secs,
            "plan": plan, "raw": raw}


def _equal(ours: list[dict], ref: list[dict], what):
    assert len(ours) == len(ref), what
    for i, (a, b) in enumerate(zip(ours, ref)):
        assert a.keys() == b.keys(), (what, i)
        for k in b:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (what, i, k)


# ------------------------- 2. the collective body vs the staged body and eager
@pytest.mark.parametrize("ref", ["staged", "eager"])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("pid", [0, 1])
def test_collective_body_equals(procs, pid, case, ref):
    r = procs["res"][pid][case]
    assert r["transports"] == [("collective", "gloo"), ("staged", "gloo")]
    _equal(r["collective"], r[ref], f"outputs vs {ref}")
    _equal(r["collective_states"], r[f"{ref}_states"], f"state vs {ref}")


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("pid", [0, 1])
def test_collective_burst_equals_steps(procs, pid, case):
    r = procs["res"][pid][case]
    _equal(r["burst"], r["collective"][:K], "burst outputs")
    _equal([r["burst_state"]], r["collective_states"][K - 1:K], "burst state")
    assert r["burst_exchanges"] == K * r["collective_per_step"]["exchanges"]
    assert r["burst_hosts"] == 0


# ------------------------------------- 3. no host exchange, no host hazard
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("pid", [0, 1])
def test_collective_body_has_no_host_exchange_sync_or_upload(procs, pid, case):
    r = procs["res"][pid][case]
    col, staged = r["collective_per_step"], r["staged_per_step"]
    # the same exchanges, none of them through the host
    assert col["hosts"] == [] and col["collectives"] == staged["hosts"]
    assert col["exchanges"] == staged["exchanges"] == len(col["collectives"]) >= 4
    assert {"halo", "gather"} <= set(col["collectives"])
    if case == "stateful":  # the last shard's cascade histories cross processes
        assert "last" in col["collectives"]
    assert r["hazards"] == []


# ------------------------------------ 4. the processes vs one process's mesh
@pytest.mark.parametrize("case", sorted(CASES))
def test_collective_union_equals_one_process_mesh(procs, case):
    rx = ShardedReceiver(procs["plan"], (2, 1), CASES[case], device="cpu")
    s, ref = rx.init_state(), []
    for b in torch.from_numpy(procs["raw"][case]):
        s, o = rx.step_u8(s, b)
        ref.append({k: v.numpy() for k, v in o.items()})
    for pid in (0, 1):  # every process holds every output
        _equal(procs["res"][pid][case]["collective"], ref, f"process {pid}")
    owner = multihost.output_key_owner(rx.plan, 2)
    assert {multihost.key_owner(owner, k) for k in ref[0]} == {0, 1}
    union = [{k: procs["res"][multihost.key_owner(owner, k) or 0][case]["collective"][i][k]
              for k in o} for i, o in enumerate(ref)]
    _equal(union, ref, "union")


# ----------------------------------------------- 5. the processes vs JAX's mesh
@pytest.mark.parametrize("ref", ["pallas", "jnp"])
def test_collective_matches_jax_sharded(procs, ref):
    raw = procs["raw"]["flagship"]
    rx = ShardedReceiver(procs["plan"], (2, 1), CASES["flagship"], device="cpu")
    pallas = ref == "pallas"
    jrx = JShardedReceiver(jbuild_plan(graft._benchmark_config()),
                           jmake_mesh(n_time=2, n_chan=1, devices=jax.devices()[:2]),
                           CASES["flagship"], use_pallas=pallas, pallas_interpret=pallas)
    js, jo = jrx.step_many_u8(jrx.init_state(), jnp.asarray(raw))
    theirs = [jrx.split_audio({k: np.asarray(v) for k, v in x.items()})
              for x in jrx.unstack_outputs(jo, N_BLOCKS)]
    for pid in (0, 1):
        ours = [rx.split_audio(o) for o in procs["res"][pid]["flagship"]["collective"]]
        _assert_audio_close(ours, theirs)
    a, b = procs["res"][1]["flagship"]["collective_states"][-1], jrx.export_state(js)
    assert a.keys() == b.keys()
    for k, v in b.items():
        assert a[k].shape == v.shape and a[k].dtype == v.dtype, k
        if v.dtype == np.uint32:
            np.testing.assert_array_equal(a[k], v, err_msg=k)
        else:
            np.testing.assert_allclose(a[k], v, rtol=0, atol=1e-3, err_msg=k)


# ----------------------------------------------------- 6. a peer that is gone
def test_collective_without_its_peer_raises_and_exits_nonzero(procs):
    """Process 1 leaves after its results; process 0 steps on: its next
    collective that waits on process 1 raises, the error is not swallowed,
    and the process exits non-zero, well within the module's limit."""
    (so0, se0), _ = procs["out"]
    assert procs["rcs"][1] == 0
    assert procs["rcs"][0] != 0 and "stepped without its peer" not in so0
    assert "in collective" in se0, se0[-2000:]
    assert procs["secs"] < LIMIT
