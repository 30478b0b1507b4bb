"""The port's CUDA-graph step (``graph/cudagraph.py``) on the CPU.

A graph cannot be captured here, so these tests hold what a graph records:
``StepGraphs`` on a CPU receiver runs, at every call, the in-place body the
card captures once (static input, state and outputs, the new state written
back into the state buffers) with the same copies in and out.

1. That body against the functional step over 4 blocks, single steps and a
   burst of 3: outputs and exported state bit-equal, on five plans (the
   flagship at 49,152 and at 2048 with no carried tail, the alt-rate plan
   through the f32 entry at 15,360, the IQ / overlap-save / taps plan, the
   288k plan).
2. The burst body against the JAX package's ``step_many_u8`` (its
   ``lax.scan`` entry), Pallas interpret and jnp: audio within 1 LSB, flip
   rate < 1e-3; state as in ``test_flagship_state_matches_jax``.
3. No host synchronisation or host upload inside the body: no
   ``_local_scalar_dense``, ``nonzero``, ``lift_fresh*`` or host-to-device
   copy outside the two kernel wrappers' calls.
4. The contract: outputs survive later steps, donated state, resuming from
   ``import_state``, the aliasing rules of the state write-back, and the
   constructor's refusals.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import __graft_entry__ as graft
import test_altrate_e2e
from sdrreceiver_tpu.graph import build_plan as jbuild_plan
from sdrreceiver_tpu.graph.compiler import CompiledReceiver as JaxReceiver
from sdrreceiver_tpu_torch.cuda.dckernel import DcIngest
from sdrreceiver_tpu_torch.cuda.frontend import MixCascade
from sdrreceiver_tpu_torch.dist import ShardedReceiver
from sdrreceiver_tpu_torch.flagship import altrate_config, benchmark_config
from sdrreceiver_tpu_torch.graph import cudagraph
from sdrreceiver_tpu_torch.graph.compiler import CompiledReceiver
from sdrreceiver_tpu_torch.graph.config import parse_ini_text
from sdrreceiver_tpu_torch.graph.cudagraph import StepGraphs
from sdrreceiver_tpu_torch.graph.plan import build_plan
from sdrreceiver_tpu_torch.io.iqfile import synthesize_channels, to_u8
from sdrreceiver_tpu_torch.kernels import compress
from test_torch_altrate import IQ_INI, IQ_TAPS
from test_torch_receiver import _assert_audio_close

# six xdist workers share the machine's cores: a few torch threads each
torch.set_num_threads(2)

N_BLOCKS = 4
K = 3

#: name -> (plan factory, block, scope taps, step entry, tone amplitude)
PLANS = {
    "flagship": (lambda: build_plan(benchmark_config()), 49152, (), "u8", 1.0),
    "flagship_2048": (lambda: build_plan(benchmark_config()), 2048, (), "u8", 1.0),
    "altrate": (lambda: build_plan(altrate_config()), 15360, (), "f32", 1.0),
    "iq": (lambda: build_plan(parse_ini_text(IQ_INI)), 49152, IQ_TAPS, "u8", 0.5),
    "288k": (lambda: build_plan(parse_ini_text(test_altrate_e2e.INI_288)), 57600, (), "u8", 1.0),
}


def _raw(plan, block: int, amp: float) -> np.ndarray:
    """[N_BLOCKS, 2*block] u8: a USB tone in every sub-VFO, noise, a DC
    offset (seeded)."""
    subs = [s for g in plan.groups for b in g.buckets for s in b.subs]
    iq = synthesize_channels(
        N_BLOCKS * block, plan.fs, plan.center_frequency,
        [(s.frequency, 700 + 37 * i, amp) for i, s in enumerate(subs)],
        noise=amp / 2, dc_offset=2 - 1j, seed=6,
    )
    return to_u8(iq).reshape(N_BLOCKS, 2 * block)


@pytest.fixture(scope="module")
def plans():
    """name -> the receiver, its blocks, and the functional step's outputs
    and exported state after each block; computed on first use."""
    cache = {}

    def get(name):
        if name not in cache:
            make, block, taps, entry, amp = PLANS[name]
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                plan = make()
            rx = CompiledReceiver(plan, block, emit_taps=taps, device="cpu")
            raw = _raw(plan, block, amp)
            blocks = torch.from_numpy(raw if entry == "u8" else raw.astype(np.float32) - 127.0)
            s, outs, states = rx.init_state(), [], []
            for b in blocks:
                s, o = rx._step_raw(s, b)
                outs.append(o)
                states.append(rx.export_state(s))
            cache[name] = {"rx": rx, "raw": raw, "blocks": blocks, "entry": entry,
                           "outs": outs, "states": states}
        return cache[name]

    return get


def _same_outputs(ours: dict, ref: dict, what):
    assert ours.keys() == ref.keys(), what
    for k in ref:
        assert torch.equal(ours[k], ref[k]), (what, k)


def _same_state(ours: dict, ref: dict, what):
    assert ours.keys() == ref.keys(), what
    for k in ref:
        assert ours[k].dtype == ref[k].dtype and np.array_equal(ours[k], ref[k]), (what, k)


# ------------------------------------------ 1. the body vs the functional step
@pytest.mark.parametrize("name", sorted(PLANS))
def test_graph_step_body_equals_functional_step(plans, name):
    r = plans(name)
    rx, graphs = r["rx"], StepGraphs(r["rx"])
    s = rx.init_state()
    for i, b in enumerate(r["blocks"]):
        s, o = graphs.step(s, b)
        _same_outputs(o, r["outs"][i], i)
        _same_state(rx.export_state(s), r["states"][i], i)


@pytest.mark.parametrize("name", sorted(PLANS))
def test_graph_burst_body_equals_functional_steps(plans, name):
    r = plans(name)
    rx, graphs = r["rx"], StepGraphs(r["rx"])
    s, many = graphs.step(rx.init_state(), r["blocks"][:K])
    for i, o in enumerate(rx.unstack_outputs(many, K)):
        _same_outputs(o, r["outs"][i], i)
    _same_state(rx.export_state(s), r["states"][K - 1], "burst")
    # the next burst resumes from the burst's own state buffers
    s, many = graphs.step(s, r["blocks"][K:])
    _same_outputs(rx.unstack_outputs(many, 1)[0], r["outs"][K], K)


# ------------------------------------------- 2. the burst vs JAX's lax.scan
@pytest.mark.parametrize("ref", ["pallas", "jnp"])
def test_graph_burst_matches_jax_step_many(plans, ref):
    r = plans("flagship")
    rx = r["rx"]
    pallas = ref == "pallas"
    jrx = JaxReceiver(jbuild_plan(graft._benchmark_config()), rx.block, use_pallas=pallas,
                      pallas_interpret=pallas)
    js, jo = jrx.step_many_u8(jrx.init_state(), jnp.asarray(r["raw"][:K]))
    s, o = StepGraphs(rx).step(rx.init_state(), r["blocks"][:K])
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
class _HostHazards(TorchDispatchMode):
    """Records each op a CUDA graph cannot capture (a host read of a device
    value, a tensor made from host data, a host-to-device copy) outside
    the kernel wrappers' calls: on the CPU those run their plain versions,
    which the card never captures."""

    BANNED = ("aten::_local_scalar_dense", "aten::nonzero", "aten::lift_fresh",
              "aten::lift_fresh_copy")

    def __init__(self):
        super().__init__()
        self.found: list[str] = []
        self.inside = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not self.inside:
            name = func._schema.name
            upload = False
            if name == "aten::_to_copy" and kwargs.get("device") is not None:
                upload = args[0].device.type == "cpu" != torch.device(kwargs["device"]).type
            elif name == "aten::copy_":
                upload = args[1].device.type == "cpu" != args[0].device.type
            if name in self.BANNED or upload:
                self.found.append(str(func))
        return func(*args, **kwargs)


@pytest.fixture
def hazards(monkeypatch):
    mode = _HostHazards()
    for cls in (DcIngest, MixCascade):
        def forward(self, *args, _orig=cls.forward):
            mode.inside += 1
            try:
                return _orig(self, *args)
            finally:
                mode.inside -= 1
        monkeypatch.setattr(cls, "forward", forward)
    return mode


def test_hazard_check_sees_a_host_upload(hazards):
    """The check is not vacuous: the IQ compression with a Python scale
    (what the step did before its divisor was built once) uploads one."""
    x = torch.ones(8)
    with hazards:
        compress.compress_style1_planar((x, x), 2.0)
    assert hazards.found == ["aten.lift_fresh.default"] * 2  # one per plane
    hazards.found.clear()
    scale = compress.scale_tensor(2.0, "cpu")  # built once, outside the step
    with hazards:
        compress.compress_style1_planar((x, x), scale)
        x.sum().item()
    assert hazards.found == ["aten._local_scalar_dense.default"]


@pytest.mark.parametrize("name", sorted(PLANS))
def test_graph_body_has_no_host_sync_or_upload(plans, name, hazards):
    r = plans(name)
    rx, graphs = r["rx"], StepGraphs(r["rx"])
    s, _ = graphs.step(rx.init_state(), r["blocks"][0])  # builds the state buffers
    with hazards:
        s, o = graphs.step(s, r["blocks"][1])
        graphs.step(s, r["blocks"][2:4])
    assert hazards.found == [], hazards.found
    _same_outputs(o, r["outs"][1], 1)


# ----------------------------------------------------- 4. the contract
def test_outputs_survive_later_steps_and_state_is_donated(plans):
    r = plans("iq")
    rx, graphs = r["rx"], StepGraphs(r["rx"])
    s0 = rx.init_state()
    s1, o1 = graphs.step(s0, r["blocks"][0])
    kept = {k: v.clone() for k, v in o1.items()}
    s2, _ = graphs.step(s1, r["blocks"][1])
    _same_outputs(o1, kept, "after the next step")
    _same_outputs(o1, r["outs"][0], 0)
    # the state returned is the receiver's buffers, updated in place: the
    # state passed in was consumed; a state that is not those buffers was
    # copied in, not consumed
    for (_, a), (_, b), (_, c) in zip(cudagraph.flatten(s1), cudagraph.flatten(s2),
                                      cudagraph.flatten(graphs.state)):
        assert a is b is c
    _same_state(rx.export_state(s1), r["states"][1], "donated")
    _same_state(rx.export_state(s0), rx.export_state(rx.init_state()), "copied in")


def test_resume_from_import_state(plans):
    """Blocks 1-2, export, import; then block 3 on the same graphs, from
    the imported state (copied into the buffers) and from a fresh state."""
    r = plans("flagship")
    rx, graphs = r["rx"], StepGraphs(r["rx"])
    s = rx.init_state()
    for b in r["blocks"][:2]:
        s, _ = graphs.step(s, b)
    named = rx.export_state(s)
    graphs.step(rx.init_state(), r["blocks"][0])  # the buffers now hold another stream
    s, o = graphs.step(rx.import_state(named), r["blocks"][2])
    _same_outputs(o, r["outs"][2], 2)
    _same_state(rx.export_state(s), r["states"][2], 2)
    s, o = graphs.step(rx.init_state(), r["blocks"][0])
    _same_outputs(o, r["outs"][0], "fresh")


def test_write_back_aliasing():
    """A leaf kept as it is, a view of another old leaf, two leaves
    swapped, and an output that is a view of the old state: each written
    as the functional state says, the output kept."""
    a, b, c = torch.arange(5.0), torch.arange(6.0) + 10, torch.arange(4.0) + 20
    want = {"b": torch.cat([a, a[:1]]), "p": [b[1:].clone(), c.clone()]}
    # "b" is written first; "a" then reads the OLD b, through a view of it
    dst = {"b": b, "p": [a, c]}
    cudagraph.write_back(dst, {"b": torch.cat([a, a[:1]]), "p": [b[1:], c]})
    assert dst["p"][1] is c and torch.equal(c, want["p"][1])
    assert torch.equal(b, want["b"]) and torch.equal(a, want["p"][0])
    x, y = torch.arange(3.0), torch.arange(3.0) + 5
    dst = {"x": x, "y": y}
    out = {"view": x[1:]}
    cudagraph.write_back(dst, {"x": y, "y": x}, out)  # swapped
    assert torch.equal(x, torch.arange(3.0) + 5) and torch.equal(y, torch.arange(3.0))
    assert torch.equal(out["view"], torch.tensor([1.0, 2.0]))
    with pytest.raises(ValueError, match="state 'x'"):
        cudagraph.write_back(dst, {"x": torch.zeros(4), "y": y})
    with pytest.raises(ValueError, match="leaves differ"):
        cudagraph.write_back(dst, {"x": x})


def test_constructor_refusals_and_defaults():
    plan = build_plan(benchmark_config())
    with pytest.raises(ValueError, match="cuda_graphs=True needs use_kernels=True"):
        CompiledReceiver(plan, 49152, device="cpu", use_kernels=False)
    rx = CompiledReceiver(plan, 49152, device="cpu", use_kernels=False, cuda_graphs=False)
    assert rx._graphs is None
    assert CompiledReceiver(plan, 49152, device="cpu")._graphs is None  # eager on the CPU
    # a mesh in one process takes the graphs on the card (dist/meshgraph.py,
    # tests/test_torch_meshgraphs.py); on the CPU it steps eagerly too
    sharded = ShardedReceiver(plan, (2, 1), 49152, device="cpu")
    assert sharded.cuda_graphs is True and sharded._graphs is None
    assert ShardedReceiver(plan, (2, 1), 49152, device="cpu", cuda_graphs=False)._graphs is None
    with pytest.raises(ValueError, match=r"\[k, 98304\]"):
        rx.step_many_u8(rx.init_state(), torch.zeros(98304, dtype=torch.uint8))
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the receiver builds there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CompiledReceiver(plan, 49152)
