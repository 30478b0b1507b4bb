"""The port's mesh step as CUDA graphs (``dist/meshgraph.py``) on the CPU.

A graph cannot be captured here, so these tests hold what the graphs of a
mesh step record: ``MeshGraphs`` on a CPU ``ShardedReceiver`` runs, at every
call, the in-place body the card captures once, its transfers copied into
the same static buffers each call (the copies between the phase graphs on
the card), with the same static input, state and outputs.

1. That body against the eager sharded step over 4 blocks, single steps
   and a burst of 3: outputs (audio, ``iq/``, ``tap/``) and exported state
   bit-equal, on the flagship at 4x1, 2x2 and 1x4, the IQ / overlap-save /
   taps plan at 2x2, and the flagship at block 2048 over 4 shards (shorter
   than the kernels' warm-up: the stateful halo path).
2. The burst body against the JAX package's ``ShardedReceiver.step_many_u8``
   at 4x1, Pallas interpret and jnp: audio within 1 LSB, flip rate < 1e-3.
3. No host synchronisation or host upload inside any phase body; the check
   sees the per-step ``a_t`` upload the halo DC made before.
4. The contract: outputs survive later steps, donated state, resuming from
   ``import_state``, checkpoints crossing to the one-device receiver and to
   the JAX package, and the constructor's defaults and refusals.

A mesh across processes runs the same bodies with its gloo exchanges
between the phases: ``tests/test_torch_procgraphs.py``.
"""

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
from sdrreceiver_tpu.graph.compiler import CompiledReceiver as JaxReceiver
from sdrreceiver_tpu_torch.dist import Mesh, ShardedReceiver
from sdrreceiver_tpu_torch.dist.meshgraph import MeshGraphs
from sdrreceiver_tpu_torch.flagship import benchmark_config
from sdrreceiver_tpu_torch.graph import cudagraph
from sdrreceiver_tpu_torch.graph.compiler import CompiledReceiver
from sdrreceiver_tpu_torch.graph.config import parse_ini_text
from sdrreceiver_tpu_torch.graph.plan import build_plan
from sdrreceiver_tpu_torch.io.iqfile import synthesize_channels, to_u8
from sdrreceiver_tpu_torch.kernels import dc
from test_torch_altrate import IQ_INI, IQ_TAPS
from test_torch_graphs import _HostHazards, _same_outputs, _same_state, hazards  # noqa: F401
from test_torch_receiver import _assert_audio_close

# six xdist workers share the machine's cores: a few torch threads each
torch.set_num_threads(2)

N_BLOCKS = 4
K = 3

#: name -> (plan factory, mesh shape, block, scope taps, tone amplitude)
CASES = {
    "flagship_4x1": (lambda: build_plan(benchmark_config()), (4, 1), 49152, (), 1.0),
    "flagship_2x2": (lambda: build_plan(benchmark_config()), (2, 2), 49152, (), 1.0),
    "flagship_1x4": (lambda: build_plan(benchmark_config()), (1, 4), 49152, (), 1.0),
    "iq_2x2": (lambda: build_plan(parse_ini_text(IQ_INI)), (2, 2), 49152, IQ_TAPS, 0.5),
    "stateful_4x1": (lambda: build_plan(benchmark_config()), (4, 1), 2048, (), 1.0),
}


def _raw(plan, block: int, amp: float) -> np.ndarray:
    """[N_BLOCKS, 2*block] u8: a USB tone in every sub-VFO, noise, a DC
    offset (seeded)."""
    subs = [s for g in plan.groups for b in g.buckets for s in b.subs]
    iq = synthesize_channels(
        N_BLOCKS * block, plan.fs, plan.center_frequency,
        [(s.frequency, 700 + 37 * i, amp) for i, s in enumerate(subs)],
        noise=amp / 2, dc_offset=2 - 1j, seed=7,
    )
    return to_u8(iq).reshape(N_BLOCKS, 2 * block)


@pytest.fixture(scope="module")
def cases():
    """name -> the sharded receiver (eager on the CPU), its blocks, and the
    eager step's outputs and exported state after each block; computed on
    first use."""
    cache = {}

    def get(name):
        if name not in cache:
            make, shape, block, taps, amp = CASES[name]
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                plan = make()
            rx = ShardedReceiver(plan, shape, block, emit_taps=taps, device="cpu")
            assert rx._graphs is None  # the CPU steps eagerly
            raw = _raw(plan, block, amp)
            blocks = torch.from_numpy(raw)
            s, outs, states = rx.init_state(), [], []
            for b in blocks:
                s, o = rx.step_u8(s, b)
                outs.append(o)
                states.append(rx.export_state(s))
            cache[name] = {"rx": rx, "plan": plan, "raw": raw, "blocks": blocks,
                           "outs": outs, "states": states}
        return cache[name]

    return get


# ------------------------------- 1. the phase bodies vs the eager mesh step
@pytest.mark.parametrize("name", sorted(CASES))
def test_mesh_graph_step_body_equals_eager_step(cases, name):
    r = cases(name)
    rx, graphs = r["rx"], MeshGraphs(r["rx"])
    s = rx.init_state()
    for i, b in enumerate(r["blocks"]):
        s, o = graphs.step(s, b)
        _same_outputs(o, r["outs"][i], i)
        _same_state(rx.export_state(s), r["states"][i], i)
    if name == "iq_2x2":
        assert any(k.startswith("iq/") for k in o) and any(k.startswith("tap/") for k in o)
    # every transfer reuses its static buffers: one set per exchange of a step
    (entry,) = graphs._entries.values()
    assert entry.body.transfers.calls == len(entry.body.transfers.bufs) > 0


@pytest.mark.parametrize("name", sorted(CASES))
def test_mesh_graph_burst_body_equals_steps(cases, name):
    r = cases(name)
    rx, graphs = r["rx"], MeshGraphs(r["rx"])
    s, many = graphs.step(rx.init_state(), r["blocks"][:K])
    for i, o in enumerate(rx.unstack_outputs(many, K)):
        _same_outputs(o, r["outs"][i], i)
    _same_state(rx.export_state(s), r["states"][K - 1], "burst")
    s, many = graphs.step(s, r["blocks"][K:])
    _same_outputs(rx.unstack_outputs(many, 1)[0], r["outs"][K], K)
    # a burst of k makes the transfers of k steps
    step_calls = MeshGraphs(rx)
    step_calls.step(rx.init_state(), r["blocks"][0])
    per_step = next(iter(step_calls._entries.values())).body.transfers.calls
    burst = graphs._entries[(torch.uint8, tuple(r["blocks"][:K].shape))]
    assert burst.body.transfers.calls == K * per_step


# ----------------------------------- 2. the burst vs JAX's sharded lax.scan
@pytest.mark.parametrize("ref", ["pallas", "jnp"])
def test_mesh_graph_burst_matches_jax_sharded(cases, ref):
    r = cases("flagship_4x1")
    rx = r["rx"]
    pallas = ref == "pallas"
    jrx = JShardedReceiver(jbuild_plan(graft._benchmark_config()),
                           jmake_mesh(n_time=4, n_chan=1, devices=jax.devices()[:4]),
                           rx.block, use_pallas=pallas, pallas_interpret=pallas)
    js, jo = jrx.step_many_u8(jrx.init_state(), jnp.asarray(r["raw"][:K]))
    s, o = MeshGraphs(rx).step(rx.init_state(), r["blocks"][:K])
    ours = [rx.split_audio({k: v.numpy() for k, v in x.items()}) for x in rx.unstack_outputs(o, K)]
    theirs = [jrx.split_audio({k: np.asarray(v) for k, v in x.items()})
              for x in jrx.unstack_outputs(jo, K)]
    _assert_audio_close(ours, theirs)
    a, b = rx.export_state(s), jrx.export_state(js)
    assert a.keys() == b.keys()
    for k, v in b.items():
        assert a[k].shape == v.shape and a[k].dtype == v.dtype, k
        if v.dtype == np.uint32:
            np.testing.assert_array_equal(a[k], v, err_msg=k)
        else:
            np.testing.assert_allclose(a[k], v, rtol=0, atol=1e-3, err_msg=k)


# ------------------------------------------------- 3. capture hazards
def test_hazard_check_sees_the_old_dc_upload(hazards):
    """The check is not vacuous: the halo DC's shard decay ``a_t`` as it
    was made on every step before (a host scalar made a tensor) uploads;
    the one built once per device and size does not, after its first
    call."""
    t_local = 12288
    with hazards:
        torch.tensor(np.float32(dc.decay_pow(dc.DEFAULT_ALPHA, float(t_local))), device="cpu")
    assert hazards.found == ["aten.lift_fresh.default"]
    hazards.found.clear()
    dc.decay_scalar(dc.DEFAULT_ALPHA, t_local, torch.device("cpu"))  # built outside the step
    with hazards:
        dc.decay_scalar(dc.DEFAULT_ALPHA, t_local, torch.device("cpu"))
    assert hazards.found == []


@pytest.mark.parametrize("name", sorted(CASES))
def test_mesh_graph_body_has_no_host_sync_or_upload(cases, name, hazards):
    r = cases(name)
    rx, graphs = r["rx"], MeshGraphs(r["rx"])
    s, _ = graphs.step(rx.init_state(), r["blocks"][0])  # builds the static buffers
    with hazards:
        s, o = graphs.step(s, r["blocks"][1])
        graphs.step(s, r["blocks"][2:4])
    assert hazards.found == [], hazards.found
    _same_outputs(o, r["outs"][1], 1)


# ----------------------------------------------------- 4. the contract
def test_mesh_outputs_survive_later_steps_and_state_is_donated(cases):
    r = cases("iq_2x2")
    rx, graphs = r["rx"], MeshGraphs(r["rx"])
    s0 = rx.init_state()
    s1, o1 = graphs.step(s0, r["blocks"][0])
    kept = {k: v.clone() for k, v in o1.items()}
    s2, _ = graphs.step(s1, r["blocks"][1])
    _same_outputs(o1, kept, "after the next step")
    for (_, a), (_, b), (_, c) in zip(cudagraph.flatten(s1), cudagraph.flatten(s2),
                                      cudagraph.flatten(graphs.state)):
        assert a is b is c
    _same_state(rx.export_state(s1), r["states"][1], "donated")
    _same_state(rx.export_state(s0), rx.export_state(rx.init_state()), "copied in")


def test_mesh_resume_from_import_state(cases):
    """Blocks 1-2 on the graph path, export, import; block 3 on the same
    graphs from the imported state, after the buffers held another stream."""
    r = cases("flagship_2x2")
    rx, graphs = r["rx"], MeshGraphs(r["rx"])
    s = rx.init_state()
    for b in r["blocks"][:2]:
        s, _ = graphs.step(s, b)
    named = rx.export_state(s)
    graphs.step(rx.init_state(), r["blocks"][0])
    s, o = graphs.step(rx.import_state(named), r["blocks"][2])
    _same_outputs(o, r["outs"][2], 2)
    _same_state(rx.export_state(s), r["states"][2], 2)


@pytest.mark.parametrize("other", ["one_device", "jax"])
def test_mesh_graph_checkpoint_crosses(cases, other):
    """Block 1 on the mesh graph path, exported, block 2 on the other
    receiver (the port's one-device one, JAX's one-device one) from it;
    and block 1 there, block 2 on the mesh graph path: each within 1 LSB of
    the straight run of the receiver that took block 2."""
    r = cases("flagship_4x1")
    rx, blocks, raw = r["rx"], r["blocks"], r["raw"]
    if other == "jax":
        orx = JaxReceiver(jbuild_plan(graft._benchmark_config()), rx.block)
        host, o_blocks = np.asarray, [jnp.asarray(b) for b in raw[:2]]
    else:
        orx = CompiledReceiver(r["plan"], rx.block, device="cpu")
        host, o_blocks = (lambda t: t.numpy()), list(blocks[:2])
    graphs = MeshGraphs(rx)
    # mesh -> other
    s, _ = graphs.step(rx.init_state(), blocks[0])
    _, got = orx.step_u8(orx.import_state(rx.export_state(s)), o_blocks[1])
    o_s, _ = orx.step_u8(orx.init_state(), o_blocks[0])
    _, ref = orx.step_u8(o_s, o_blocks[1])
    _assert_audio_close([orx.split_audio({k: host(v) for k, v in got.items()})],
                        [orx.split_audio({k: host(v) for k, v in ref.items()})])
    # other -> mesh
    o_s, _ = orx.step_u8(orx.init_state(), o_blocks[0])
    _, got = graphs.step(rx.import_state(orx.export_state(o_s)), blocks[1])
    _assert_audio_close([rx.split_audio({k: v.numpy() for k, v in got.items()})],
                        [rx.split_audio({k: v.numpy() for k, v in r["outs"][1].items()})])


def test_mesh_constructor_defaults_and_refusals():
    plan = build_plan(benchmark_config())
    rx = ShardedReceiver(plan, (2, 1), 49152, device="cpu")
    assert rx.cuda_graphs is True and rx._graphs is None  # eager on the CPU
    assert isinstance(rx._graphs_type(rx), MeshGraphs)
    assert ShardedReceiver(plan, (2, 1), 49152, device="cpu", cuda_graphs=False).cuda_graphs is False
    with pytest.raises(ValueError, match="cuda_graphs=True needs use_kernels=True"):
        ShardedReceiver(plan, (2, 1), 49152, device="cpu", use_kernels=False)
    # a mesh across processes takes graphs too (its gloo exchanges between
    # the phases), eager on the CPU; the plain versions still refuse them
    two = Mesh([["cpu"], ["cpu"]], ranks=[[0], [1]], rank=0)
    rx = ShardedReceiver(plan, two, 49152)
    assert rx.cuda_graphs is True and rx._graphs is None and rx._span is not None
    assert ShardedReceiver(plan, two, 49152, cuda_graphs=True).cuda_graphs is True
    assert ShardedReceiver(plan, two, 49152, cuda_graphs=False).cuda_graphs is False
    with pytest.raises(ValueError, match="cuda_graphs=True needs use_kernels=True"):
        ShardedReceiver(plan, two, 49152, use_kernels=False)
