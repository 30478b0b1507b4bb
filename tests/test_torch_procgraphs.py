"""The port's mesh step across processes as CUDA graphs (``dist/meshgraph.py``
with ``ProcessSpan`` exchanges) on the CPU.

Two processes join a gloo group and build one ``--partition global`` mesh
2x1 over it (``multihost.global_mesh``, one CPU shard each).  Each runs,
on the same 4 u8 blocks, the eager sharded step and ``MeshGraphs(rx)``:
the body the card captures, with its transfers copied between static
buffers and its exchanges made through static host buffers around the
gloo call (on the card the phase graphs end and begin with those copies),
4 single steps and one burst of k = 2.  The flagship plan at block 49,152
(the per-shard mix-cascade) and at block 2048 (shards shorter than the
warm-up: the stateful cascade, whose histories come from the last shard's
process).  The processes start once for the module; the parent holds:

1. the graph body bit-equal to the eager step, outputs and exported state,
   and the burst bit-equal to the single steps;
2. no host synchronisation or host upload inside a phase body, outside
   the exchanges' gloo calls (the hazard check of
   ``test_torch_graphs.py``, run in each process);
3. every process's outputs, and the union of the topics each publishes,
   bit-equal to the one-process 2x1 mesh;
4. the graph steps within 1 LSB (flip rate < 1e-3) of the JAX package's
   ``ShardedReceiver`` 2x1 ``step_many_u8``, Pallas interpret and jnp;
5. a step whose peer has gone raises in the gloo call, and the process
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
from sdrreceiver_tpu_torch.dist import ShardedReceiver, multihost
from sdrreceiver_tpu_torch.flagship import benchmark_config
from sdrreceiver_tpu_torch.graph.plan import build_plan
from sdrreceiver_tpu_torch.io.iqfile import synthesize_channels, to_u8
from test_torch_cli import _free_port
from test_torch_graphs import _HostHazards
from test_torch_receiver import _assert_audio_close

# six xdist workers share the machine's cores: a few torch threads each
torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
N_BLOCKS = 4
K = 2
#: name -> block (the flagship plan on a global 2x1 mesh)
CASES = {"flagship": 49152, "stateful": 2048}
#: seconds the two processes may take together
LIMIT = 240

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

def main(coord, pid, data, out):
    multihost.TIMEOUT_S = 60
    multihost.initialize(coord, 2, pid)
    mesh = multihost.global_mesh(1, ["cpu"])
    hz = _HostHazards()
    for cls, name in ((DcIngest, "forward"), (MixCascade, "forward"),
                      (multihost.ProcessSpan, "communicate")):
        def inside(*args, _orig=getattr(cls, name)):
            hz.inside += 1
            try:
                return _orig(*args)
            finally:
                hz.inside -= 1
        setattr(cls, name, inside)
    plan = build_plan(benchmark_config())
    res = {}
    for case, blocks in torch.load(data).items():
        rx = ShardedReceiver(plan, mesh, blocks.shape[1] // 2)
        assert rx._span is not None and rx.cuda_graphs and rx._graphs is None
        r = res[case] = {"eager": [], "eager_states": [], "graph": [], "graph_states": []}
        s = rx.init_state()
        for b in blocks:
            s, o = rx.step_u8(s, b)
            r["eager"].append(host(o))
            r["eager_states"].append(rx.export_state(s))
        graphs = MeshGraphs(rx)
        s = rx.init_state()
        for i, b in enumerate(blocks):
            # the first step builds the static buffers
            with hz if i else contextlib.nullcontext():
                s, o = graphs.step(s, b)
            r["graph"].append(host(o))
            r["graph_states"].append(rx.export_state(s))
        (entry,) = graphs._entries.values()
        t = entry.body.transfers
        r["per_step"] = {"transfers": t.calls, "exchanges": t.exchanges,
                         "kinds": [x.kind for x in t.hosts]}
        graphs.step(rx.init_state(), blocks[:KBURST])  # builds the burst's buffers
        s = rx.init_state()
        with hz:
            s, many = graphs.step(s, blocks[:KBURST])
        r["burst"] = [host(o) for o in rx.unstack_outputs(many, KBURST)]
        r["burst_state"] = rx.export_state(s)
        burst = graphs._entries[(torch.uint8, tuple(blocks[:KBURST].shape))]
        r["burst_exchanges"] = burst.body.transfers.exchanges
        r["hazards"] = list(hz.found)
        hz.found.clear()
        res[case]["graphs"] = graphs
    torch.save({k: {n: v for n, v in r.items() if n != "graphs"} for k, r in res.items()}, out)
    print("saved", flush=True)
    if pid == 1:
        return 0  # the peer goes: process 0's next exchange must fail
    graphs, blocks = res["flagship"]["graphs"], torch.load(data)["flagship"]
    s = graphs.state
    for i in range(50):
        s, _ = graphs.step(s, blocks[i % len(blocks)])
    print("stepped without its peer", flush=True)
    return 0

sys.exit(main(sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]))
'''


def _raw(plan, block: int) -> np.ndarray:
    """[N_BLOCKS, 2*block] u8: a USB tone in every sub-VFO, noise, a DC
    offset (seeded)."""
    subs = [s for g in plan.groups for b in g.buckets for s in b.subs]
    iq = synthesize_channels(
        N_BLOCKS * block, plan.fs, plan.center_frequency,
        [(s.frequency, 700 + 37 * i, 1.0) for i, s in enumerate(subs)],
        noise=0.5, dc_offset=2 - 1j, seed=8,
    )
    return to_u8(iq).reshape(N_BLOCKS, 2 * block)


@pytest.fixture(scope="module")
def procs(tmp_path_factory):
    """Both processes' results (``CHILD``), their exit codes, stderr and
    wall time, the plan and the blocks of each case."""
    d = tmp_path_factory.mktemp("procgraphs")
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


@pytest.fixture(scope="module")
def one_process(procs):
    """case -> outputs and exported states of the one-process 2x1 mesh
    (eager, CPU) on the same blocks."""
    out = {}
    for case, raw in procs["raw"].items():
        rx = ShardedReceiver(procs["plan"], (2, 1), CASES[case], device="cpu")
        s, outs, states = rx.init_state(), [], []
        for b in torch.from_numpy(raw):
            s, o = rx.step_u8(s, b)
            outs.append({k: v.numpy() for k, v in o.items()})
            states.append(rx.export_state(s))
        out[case] = {"rx": rx, "outs": outs, "states": states}
    return out


def _equal(ours: list[dict], ref: list[dict], what):
    assert len(ours) == len(ref), what
    for i, (a, b) in enumerate(zip(ours, ref)):
        assert a.keys() == b.keys(), (what, i)
        for k in b:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (what, i, k)


# ------------------------------- 1. the bodies vs the eager step, per process
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("pid", [0, 1])
def test_process_graph_body_equals_eager_step(procs, case, pid):
    r = procs["res"][pid][case]
    _equal(r["graph"], r["eager"], "outputs")
    _equal(r["graph_states"], r["eager_states"], "state")
    # each exchange a step makes goes through its own static buffers
    per = r["per_step"]
    assert per["exchanges"] == len(per["kinds"]) >= 4
    assert {"halo", "gather"} <= set(per["kinds"])
    if case == "stateful":  # the last shard's cascade histories cross processes
        assert "last" in per["kinds"]


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("pid", [0, 1])
def test_process_graph_burst_equals_steps(procs, case, pid):
    r = procs["res"][pid][case]
    _equal(r["burst"], r["graph"][:K], "burst outputs")
    _equal([r["burst_state"]], r["graph_states"][K - 1:K], "burst state")
    assert r["burst_exchanges"] == K * r["per_step"]["exchanges"]


# ----------------------------------------- 2. capture hazards in each process
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("pid", [0, 1])
def test_process_graph_body_has_no_host_sync_or_upload(procs, case, pid):
    assert procs["res"][pid][case]["hazards"] == []


# -------------------------------------- 3. the processes vs one process's mesh
@pytest.mark.parametrize("case", sorted(CASES))
def test_process_union_equals_one_process_mesh(procs, one_process, case):
    ref = one_process[case]
    rx = ref["rx"]
    for pid in (0, 1):  # every process holds every output and the whole state
        _equal(procs["res"][pid][case]["graph"], ref["outs"], f"process {pid}")
        _equal(procs["res"][pid][case]["graph_states"], ref["states"], f"process {pid} state")
    owner = multihost.output_key_owner(rx.plan, 2)
    union = [{k: procs["res"][multihost.key_owner(owner, k) or 0][case]["graph"][i][k]
              for k in o} for i, o in enumerate(ref["outs"])]
    assert {multihost.key_owner(owner, k) for k in ref["outs"][0]} == {0, 1}
    _equal(union, ref["outs"], "union")


# ---------------------------------------------- 4. the processes vs JAX's mesh
@pytest.mark.parametrize("ref", ["pallas", "jnp"])
def test_process_graphs_match_jax_sharded(procs, one_process, ref):
    raw = procs["raw"]["flagship"]
    rx = one_process["flagship"]["rx"]
    pallas = ref == "pallas"
    jrx = JShardedReceiver(jbuild_plan(graft._benchmark_config()),
                           jmake_mesh(n_time=2, n_chan=1, devices=jax.devices()[:2]),
                           CASES["flagship"], use_pallas=pallas, pallas_interpret=pallas)
    js, jo = jrx.step_many_u8(jrx.init_state(), jnp.asarray(raw))
    theirs = [jrx.split_audio({k: np.asarray(v) for k, v in x.items()})
              for x in jrx.unstack_outputs(jo, N_BLOCKS)]
    for pid in (0, 1):
        ours = [rx.split_audio(o) for o in procs["res"][pid]["flagship"]["graph"]]
        _assert_audio_close(ours, theirs)
    a, b = procs["res"][0]["flagship"]["graph_states"][-1], jrx.export_state(js)
    assert a.keys() == b.keys()
    for k, v in b.items():
        assert a[k].shape == v.shape and a[k].dtype == v.dtype, k
        if v.dtype == np.uint32:
            np.testing.assert_array_equal(a[k], v, err_msg=k)
        else:
            np.testing.assert_allclose(a[k], v, rtol=0, atol=1e-3, err_msg=k)


# ----------------------------------------------------- 5. a peer that is gone
def test_step_without_its_peer_raises_and_exits_nonzero(procs):
    """Process 1 leaves after its results; process 0 steps on: its next
    exchange that waits on process 1 raises inside the gloo call, the
    error is not swallowed, and the process exits non-zero, well within
    the module's limit."""
    (so0, se0), (so1, _) = procs["out"]
    assert procs["rcs"][1] == 0
    assert procs["rcs"][0] != 0 and "stepped without its peer" not in so0
    assert "in communicate" in se0, se0[-2000:]
    assert procs["secs"] < LIMIT
