"""The port's dist/ (halo exchange, ShardedReceiver, the two multi-process
partitions) vs the JAX package's, on the CPU.

The halo functions run on lists of time shards (``["cpu"] * 8`` as the
mesh's devices) against JAX ``dist.halo`` under ``shard_map`` on the eight
virtual CPU devices (tests/conftest.py): the NCO phases exact, the cascade
and the DC to float tolerance.  The sharded receiver runs
tests/test_dist.py's plan at BLOCK = 131,072 over 2 blocks at meshes 8x1,
4x2 and 2x4 against the port's single-device receiver and JAX's
ShardedReceiver on its jnp path, and at 4x2 against JAX's per-shard Pallas
path in interpret mode: int16 audio within 1 LSB with a flip rate below
1e-3, and ``iq/`` bytes equal.  Checkpoints cross both ways between the port's
sharded receiver and JAX's single-device one.  The multi-process
partitions run as two ``process-file`` processes on gloo.  Every JAX
reference is computed once per module.
"""

import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import __graft_entry__ as graft
import test_dist
from sdrreceiver_tpu.dist import ShardedReceiver as JShardedReceiver
from sdrreceiver_tpu.dist import halo as jhalo
from sdrreceiver_tpu.dist import make_mesh as jmake_mesh
from sdrreceiver_tpu.dist import multihost as jmultihost
from sdrreceiver_tpu.graph import build_plan as jbuild_plan
from sdrreceiver_tpu.graph import parse_ini_text as jparse
from sdrreceiver_tpu.graph.compiler import CompiledReceiver as JaxReceiver
from sdrreceiver_tpu.kernels import dc as jdc
from sdrreceiver_tpu.kernels import halfband as jhalfband
from sdrreceiver_tpu.kernels import nco as jnco
from sdrreceiver_tpu_torch.cli.main import main
from sdrreceiver_tpu_torch.cuda.frontend import MixCascade
from sdrreceiver_tpu_torch.dist import ShardedReceiver, halo, make_mesh, multihost
from sdrreceiver_tpu_torch.flagship import altrate_config, benchmark_config
from sdrreceiver_tpu_torch.graph.compiler import CompiledReceiver
from sdrreceiver_tpu_torch.graph.config import parse_ini_text
from sdrreceiver_tpu_torch.graph.plan import build_plan
from sdrreceiver_tpu_torch.kernels import design, fir, nco
from test_torch_cli import _free_port
from test_torch_modules import _to_ini

# six xdist workers share the machine's cores: a few torch threads each
torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
BLOCK = test_dist.BLOCK  # 131072
INI = test_dist.INI
CPU8 = ["cpu"] * 8


def _shards(a: np.ndarray, n: int) -> list[torch.Tensor]:
    return list(torch.from_numpy(a).chunk(n, dim=-1))


def _smap(fn, n, in_specs, out_specs):
    return jax.jit(jax.shard_map(fn, mesh=jmake_mesh(n_time=n, devices=jax.devices()[:n]),
                                 in_specs=in_specs, out_specs=out_specs, check_vma=False))


# ------------------------------------------------------------- halos
@pytest.mark.parametrize("n", [8, 4, 2])
def test_right_halo_equals_jax(rng, n):
    x = rng.standard_normal((2, 3, 256)).astype(np.float32)
    ref = _smap(lambda a: jhalo.right_halo(a, 10, "time"), n, (P(None, None, "time"),),
                P(None, None, "time"))(jnp.asarray(x))
    got = halo.right_halo(_shards(x, n), 10)
    np.testing.assert_array_equal(torch.cat(got, dim=-1).numpy(), np.asarray(ref))


@pytest.mark.parametrize("n", [8, 4, 2])
def test_cascade_halo_equals_jax(rng, n):
    xr, xi = (rng.standard_normal((2, 4096)).astype(np.float32) for _ in range(2))
    hists = [rng.standard_normal((2, 2, 10)).astype(np.float32) for _ in range(3)]
    rt = jhalfband.cascade_taps(2)
    ref_h, ref_y = _smap(
        lambda h, a, b: jhalo.timeshard_cascade_local(h, (a, b), rt, "time"), n,
        (P(), P(None, "time"), P(None, "time")), (P(), (P(None, "time"), P(None, "time"))),
    )([jnp.asarray(h) for h in hists], jnp.asarray(xr), jnp.asarray(xi))
    rtaps = fir.prepare_taps(design.half_band(11), 2)
    got_h, got_y = halo.timeshard_cascade_local(
        [torch.from_numpy(h) for h in hists], list(zip(_shards(xr, n), _shards(xi, n))), rtaps
    )
    for p in (0, 1):
        np.testing.assert_allclose(torch.cat([y[p] for y in got_y], -1).numpy(),
                                   np.asarray(ref_y[p]), rtol=1e-6, atol=1e-6)
    for a, b in zip(got_h, ref_h):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n", [8, 4, 2])
def test_mix_halo_equals_jax(rng, n):
    """Phases are exact integers (the shard offsets and the carried phase);
    the mixed samples agree to float tolerance."""
    fs, t_len, f = 192000, 1536, 48123
    xr = rng.standard_normal(t_len).astype(np.float32)
    xi = rng.standard_normal(t_len).astype(np.float32)
    jst = jnco.nco_init([f], fs)
    jst["phase"] = jnp.asarray([12345], jnp.uint32)
    ref_st, ref_y = _smap(
        lambda s, a, b: jhalo.timeshard_mix_local(s, (a, b), fs, t_len // n, "time"), n,
        (P(), P("time"), P("time")), (P(), (P(None, "time"), P(None, "time"))),
    )(jst, jnp.asarray(xr), jnp.asarray(xi))
    st = nco.nco_init([f], fs, "cpu")
    st["phase"] = torch.tensor([12345])
    got_st, got_y = halo.timeshard_mix_local(
        st, list(zip(_shards(xr, n), _shards(xi, n))), fs, t_len // n
    )
    assert got_st["phase"].tolist() == np.asarray(ref_st["phase"]).tolist()
    for p in (0, 1):
        np.testing.assert_allclose(torch.cat([y[p] for y in got_y], -1).numpy(),
                                   np.asarray(ref_y[p]), atol=2e-6)


@pytest.mark.parametrize("n", [8, 4, 2])
def test_dc_halo_equals_jax(rng, n):
    """The JAX package's order of float operations: the sharded DC agrees
    with JAX's sharded DC to float tolerance (and with the unsharded DC)."""
    xr = (rng.standard_normal(4096) * 20 + 5).astype(np.float32)
    xi = (rng.standard_normal(4096) * 20).astype(np.float32)
    m0 = np.asarray([0.5, 0.25], np.float32)
    ref_m, ref_y = _smap(
        lambda m, a, b: jhalo.timeshard_dc_local(m, (a, b), "time"), n,
        (P(), P("time"), P("time")), (P(), (P("time"), P("time"))),
    )(jnp.asarray(m0), jnp.asarray(xr), jnp.asarray(xi))
    got_m, got_y = halo.timeshard_dc_local(
        torch.from_numpy(m0), list(zip(_shards(xr, n), _shards(xi, n)))
    )
    np.testing.assert_allclose(got_m.numpy(), np.asarray(ref_m), rtol=1e-6, atol=1e-7)
    for p in (0, 1):
        np.testing.assert_allclose(torch.cat([y[p] for y in got_y]).numpy(),
                                   np.asarray(ref_y[p]), rtol=1e-6, atol=2e-6)
    um, _ = jdc.dc_block_planar(jnp.asarray(m0), (jnp.asarray(xr), jnp.asarray(xi)))
    np.testing.assert_allclose(got_m.numpy(), np.asarray(um), rtol=1e-5)


def test_make_mesh_errors_equal_jax():
    with pytest.raises(ValueError, match="3x2 mesh != 8 devices"):
        make_mesh(3, 2, devices=CPU8)
    with pytest.raises(ValueError, match="3x2 mesh != 8 devices"):
        jmake_mesh(3, 2)
    m = make_mesh(n_chan=2, devices=CPU8)
    assert m.shape == dict(jmake_mesh(n_chan=2).shape) == {"time": 4, "chan": 2}
    if not torch.cuda.is_available():  # the default devices are the cards, never the CPU
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_mesh(2, 1)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ShardedReceiver(build_plan(parse_ini_text(INI)), (2, 1), BLOCK)


# --------------------------------------------------- sharded receiver
def _signal() -> np.ndarray:
    """tests/test_dist.py's two-block complex signal."""
    rng = np.random.default_rng(9)
    t_len = 2 * BLOCK
    n = np.arange(t_len)
    x = 0.4 * np.exp(2j * np.pi * ((1545005146 - 1545600000) + 900) * n / 1536000)
    x = x + 0.3 * np.exp(2j * np.pi * ((1546005300 - 1545600000) + 2000) * n / 1536000)
    x = x + 0.05 * (rng.standard_normal(t_len) + 1j * rng.standard_normal(t_len))
    return (x + (2 - 1j)).astype(np.complex64).reshape(2, BLOCK)


def _run(rx, x, state=None, jax_rx=False):
    """(outputs joined over the blocks as numpy, exported state)."""
    s = rx.init_state() if state is None else state
    outs = []
    for blk in x:
        s, o = rx.step_iq(s, jnp.asarray(blk) if jax_rx else torch.from_numpy(blk))
        outs.append({k: np.asarray(v) for k, v in o.items()})
    return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}, rx.export_state(s)


def _close(got: dict, ref: dict):
    """Audio within 1 LSB, flip rate < 1e-3 pooled; ``iq/`` equal; taps to
    float tolerance."""
    assert set(got) == set(ref)
    flips = total = 0
    for k, r in ref.items():
        assert got[k].shape == r.shape, k
        if k.startswith("iq/"):
            np.testing.assert_array_equal(got[k], r, err_msg=k)
        elif k.startswith("tap/"):
            np.testing.assert_allclose(got[k], r, rtol=1e-5, atol=2e-4, err_msg=k)
        else:
            d = np.abs(got[k].astype(np.int32) - r.astype(np.int32))
            assert d.max() <= 1, k
            flips, total = flips + int((d > 0).sum()), total + d.size
    assert flips / total < 1e-3, flips / total


@pytest.fixture(scope="module")
def sharded():
    plan, jplan = build_plan(parse_ini_text(INI)), jbuild_plan(jparse(INI))
    x = _signal()
    rx = ShardedReceiver(plan, make_mesh(4, 2, CPU8), BLOCK)
    runs: dict = {}

    def jax_run(shape, pallas=False):
        """JAX's ShardedReceiver at ``shape`` (once per module)."""
        if (shape, pallas) not in runs:
            jrx = JShardedReceiver(jplan, jmake_mesh(n_time=shape[0], n_chan=shape[1]), BLOCK,
                                   use_pallas=pallas, pallas_interpret=pallas)
            runs[shape, pallas] = _run(jrx, x, jax_rx=True)
        return runs[shape, pallas]

    return {
        "plan": plan, "jplan": jplan, "x": x, "rx": rx, "jax": jax_run,
        "single": _run(CompiledReceiver(plan, BLOCK, device="cpu"), x),
        "port": _run(rx, x),
    }


@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 4)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_matches_single_device(sharded, shape):
    """Against the port's single-device receiver and JAX's ShardedReceiver
    (jnp path) at the same shape."""
    rx = ShardedReceiver(sharded["plan"], make_mesh(*shape, CPU8), BLOCK)
    got, st = _run(rx, sharded["x"])
    _close(got, sharded["single"][0])
    _close(got, sharded["jax"](shape)[0])
    ref_st = sharded["single"][1]
    assert set(st) == set(ref_st)
    for k, r in ref_st.items():
        assert st[k].shape == r.shape and st[k].dtype == r.dtype, k
        if r.dtype == np.uint32:
            np.testing.assert_array_equal(st[k], r, err_msg=k)
        else:
            np.testing.assert_allclose(st[k], r, rtol=0, atol=1e-3, err_msg=k)


@pytest.mark.parametrize("ref", ["jnp", "pallas"])
def test_sharded_matches_jax_sharded(sharded, ref):
    """At 4x2 against JAX's ShardedReceiver on its jnp path and on its
    per-shard Pallas path (interpret mode)."""
    _close(sharded["port"][0], sharded["jax"]((4, 2), pallas=ref == "pallas")[0])


def test_shard_kernels_engage_and_no_bucket_kernel(sharded, monkeypatch):
    """One merged per-shard kernel covers both cascaded groups: n_time
    calls a step, each of its own wrapper; no bucket kernel is built or
    called, and the channels split over the chan axis."""
    rx = sharded["rx"]
    sites = rx.mix_cascades()
    assert sorted(sites) == [f"shard{i}/front" for i in range(4)]
    assert all(mc.depths == [2, 3] and t == BLOCK // 4 + 256 for mc, t in sites.values())
    assert rx._bucket_mc == {} and [gidxs for _, _, gidxs in rx._fronts] == [[0, 1]]
    assert [(lo, hi) for lo, hi, _, _ in rx._chan_parts["g0/b0"]] == [(0, 2), (2, 3)]
    calls = []
    plain = MixCascade.plain
    monkeypatch.setattr(MixCascade, "plain", lambda self, *a: calls.append(self) or plain(self, *a))
    _run(rx, sharded["x"][:1])
    assert calls == [mc for mc, _ in sites.values()]


def test_burst_equals_single_steps(sharded):
    rx, x = sharded["rx"], sharded["x"]
    sm, om = rx.step_many_iq(rx.init_state(), torch.from_numpy(x))
    per = rx.unstack_outputs(om, 2)
    s = rx.init_state()
    for i in range(2):
        s, o = rx.step_iq(s, torch.from_numpy(x[i]))
        assert set(o) == set(per[i]) and all(torch.equal(o[k], per[i][k]) for k in o)
    a, b = rx.export_state(sm), rx.export_state(s)
    assert all(np.array_equal(a[k], b[k]) for k in a)


def test_sharded_taps_and_overlap_save(sharded):
    taps = ("main", "g0", "VFO01", "VFO13")
    plan = sharded["plan"]
    ref_rx = CompiledReceiver(plan, BLOCK, emit_taps=taps, device="cpu")
    rx = ShardedReceiver(plan, make_mesh(4, 2, CPU8), BLOCK, emit_taps=taps)
    assert "g1/b0" in rx._oss and "g1/b0" in ref_rx._oss  # VFO13's 154-tap filter
    ref, got = _run(ref_rx, sharded["x"])[0], _run(rx, sharded["x"])[0]
    assert {f"tap/{t}" for t in taps} <= set(ref)
    _close(got, ref)


def test_block_divisibility_names_n_time(sharded):
    with pytest.raises(ValueError, match="n_time"):
        ShardedReceiver(sharded["plan"], make_mesh(8, 1, CPU8), sharded["plan"].block_divisor() * 4)


def test_short_shards_take_the_halo_path(sharded):
    """At block 1024 over 8 shards (128 samples each, under the kernels'
    warm-up) there is no carried tail: every group takes the halo path
    (mix + cascade with halo exchange), against the single-device
    receiver's stateful path over 16 blocks."""
    plan, x = sharded["plan"], sharded["x"][0][:16 * 1024].reshape(16, 1024)
    rx = ShardedReceiver(plan, make_mesh(8, 1, CPU8), 1024)
    assert rx.xtail_len() == 0 and rx.mix_cascades() == {}
    _close(_run(rx, x)[0], _run(CompiledReceiver(plan, 1024, device="cpu"), x)[0])


def test_cband_66_channels_2x4():
    """tests/test_dist.py's 66-channel, 3-group plan at its block (4 x its
    divisor) on a 2x4 mesh against one device."""
    text = test_dist._cband_scale_ini(66)
    plan = build_plan(parse_ini_text(text))
    block = plan.block_divisor() * 4
    rng = np.random.default_rng(1234)
    n = np.arange(2 * block)
    x = 0.4 * np.exp(2j * np.pi * (-783000 + 900) * n / 1536000)
    x += 0.3 * np.exp(2j * np.pi * (196000 + 2000) * n / 1536000)
    x += 0.05 * (rng.standard_normal(2 * block) + 1j * rng.standard_normal(2 * block))
    x = (x + (0.5 - 0.25j)).astype(np.complex64).reshape(2, block)
    rx = ShardedReceiver(plan, make_mesh(2, 4, CPU8), block)
    assert plan.num_channels() >= 64 and len(plan.groups) == 3 and len(rx._chan_parts) == 3
    _close(_run(rx, x)[0], _run(CompiledReceiver(plan, block, device="cpu"), x)[0])


@pytest.mark.parametrize("first", ["jax", "port"])
def test_checkpoint_crosses(sharded, first):
    """Block 1 in one package (the port sharded at 4x2, JAX on one device),
    exported; block 2 in the other from that state: the second block of the
    first package's straight run, within 1 LSB."""
    plan, jplan, x = sharded["plan"], sharded["jplan"], sharded["x"]
    port, jrx = sharded["rx"], JaxReceiver(jplan, BLOCK)
    if first == "jax":
        s, _ = jrx.step_iq(jrx.init_state(), jnp.asarray(x[0]))
        got, _ = _run(port, x[1:], port.import_state(jrx.export_state(s)))
        ref, _ = _run(jrx, x[1:], s, jax_rx=True)
    else:
        s, _ = port.step_iq(port.init_state(), torch.from_numpy(x[0]))
        got, _ = _run(jrx, x[1:], jrx.import_state(port.export_state(s)), jax_rx=True)
        ref, _ = _run(port, x[1:], s)
    _close(got, ref)


# ------------------------------------------------- multihost functions
def _plans():
    return {
        "flagship": (_to_ini(benchmark_config()), graft._benchmark_config()),
        "altrate": (_to_ini(altrate_config()), graft._altrate_config()),
        "dist": (INI, None),
        "cband66": (test_dist._cband_scale_ini(66), None),
    }


@pytest.mark.parametrize("n_hosts", [1, 2, 3, 4])
@pytest.mark.parametrize("name", ["flagship", "altrate", "dist", "cband66"])
def test_multihost_functions_equal_jax(name, n_hosts):
    text, jcfg = _plans()[name]
    plan = build_plan(parse_ini_text(text))
    jplan = jbuild_plan(jcfg if jcfg is not None else jparse(text))
    assert multihost.group_costs(plan) == jmultihost.group_costs(jplan)
    assign = multihost.assign_groups(plan, n_hosts)
    assert assign == jmultihost.assign_groups(jplan, n_hosts)
    for h in range(n_hosts):
        assert ([g.index for g in multihost.host_subplan(plan, assign, h).groups]
                == [g.index for g in jmultihost.host_subplan(jplan, assign, h).groups])
    assert multihost.assignment_report(plan, n_hosts) == jmultihost.assignment_report(jplan, n_hosts)
    assert multihost.egress_owner(plan, n_hosts) == jmultihost.egress_owner(jplan, n_hosts)
    own = multihost.output_key_owner(plan, n_hosts)
    assert own == jmultihost.output_key_owner(jplan, n_hosts)
    assert (multihost.global_report(plan, n_hosts, 4 * n_hosts)
            == jmultihost.global_report(jplan, n_hosts, 4 * n_hosts))
    for key in [*own, "pcm/g0/b1", "iq/none", "tap/main"]:
        assert multihost.key_owner(own, key) == jmultihost.key_owner(own, key)


def test_key_owner_prefix_vs_exact():
    own = {"iq/A": 0, "iq/AB": 1, "pcm/g0/": 0, "pcm/g1/": 1}
    assert multihost.key_owner(own, "iq/A") == 0
    assert multihost.key_owner(own, "iq/AB") == 1
    assert multihost.key_owner(dict(reversed(list(own.items()))), "iq/AB") == 1
    assert multihost.key_owner(own, "pcm/g1/b0") == 1
    assert multihost.key_owner(own, "tap/main") is None
    assert multihost.key_owner(own, "iq/ABC") is None


def test_initialize_single_process():
    assert multihost.initialize() == (0, 1)
    mesh = multihost.global_mesh(2, CPU8)
    assert mesh.shape == {"time": 4, "chan": 2} and not mesh.multiprocess


# ------------------------------------------------- two processes, gloo
@pytest.fixture(scope="module")
def recording(tmp_path_factory):
    """tests/test_multihost_proc.py's ini (2 groups, 3 channels) and a
    ~0.5 s u8 recording with a tone on each channel."""
    import test_multihost_proc as tmp
    from sdrreceiver_tpu_torch.io import iqfile

    d = tmp_path_factory.mktemp("mh")
    iq = iqfile.synthesize_channels(
        768000, 1536000, 1545600000,
        [(1545005146, 1000.0, 0.25), (1545214573, 750.0, 0.25), (1546005300, 1200.0, 0.25)],
        noise=0.01, dc_offset=0.02 + 0.01j,
    )
    iqfile.write_iq(d / "iq.u8", iq, "u8")
    for name in ("ref", "h0", "h1"):
        (d / f"{name}.ini").write_text(tmp.INI_TMPL.format(port=_free_port()))
    return d


def _audio(d: pathlib.Path) -> dict[str, bytes]:
    return {p.name: p.read_bytes() for p in d.glob("audio_*.s16")}


def _two_processes(d: pathlib.Path, out: str, *extra) -> list[dict]:
    """Two ``process-file`` processes joined on gloo; their JSON summaries."""
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "sdrreceiver_tpu_torch", "process-file", "-s",
             str(d / f"h{i}.ini"), "--iq", str(d / "iq.u8"), "--out", str(d / f"{out}{i}"),
             "--device", "cpu", "--coordinator", coord, "--num-processes", "2",
             "--process-id", str(i), *extra],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=str(REPO),
        )
        for i in (0, 1)
    ]
    try:
        res = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (so, se) in zip(procs, res):
        assert p.returncode == 0, se[-3000:]
    return [json.loads(so.strip().splitlines()[-1]) for so, _ in res]


def test_two_process_groups_union_equals_single(recording, capsys):
    d = recording
    assert main(["process-file", "-s", str(d / "ref.ini"), "--iq", str(d / "iq.u8"),
                 "--out", str(d / "ref"), "--device", "cpu"]) == 0
    capsys.readouterr()
    ref = _audio(d / "ref")
    assert len(ref) == 3
    s0, s1 = (s["multihost"] for s in _two_processes(d, "g"))
    assert s0["num_processes"] == s1["num_processes"] == 2
    assert set(s0["local_groups"]) | set(s1["local_groups"]) == {0, 1}
    a0, a1 = _audio(d / "g0"), _audio(d / "g1")
    assert a0 and a1 and not set(a0) & set(a1)  # no topic written twice
    assert {**a0, **a1} == ref  # bit for bit


def test_two_process_global_union_equals_single(recording, capsys):
    """``--partition global --mesh 2x1``: each process writes only its own
    topics, and the union equals the single-process 2x1 mesh bit for bit
    (the same float operations in the same order)."""
    d = recording
    assert main(["process-file", "-s", str(d / "ref.ini"), "--iq", str(d / "iq.u8"),
                 "--out", str(d / "m"), "--device", "cpu", "--mesh", "2x1"]) == 0
    capsys.readouterr()
    ref = _audio(d / "m")
    s0, s1 = (s["multihost"] for s in _two_processes(d, "w", "--partition", "global",
                                                     "--mesh", "2x1"))
    assert s0["mode"] == s1["mode"] == "global" and s0["report"]["n_time"] == 2
    a0, a1 = _audio(d / "w0"), _audio(d / "w1")
    assert set(a0) == {f"audio_{t}.s16" for t in s0["local_topics"]}
    assert set(a1) == {f"audio_{t}.s16" for t in s1["local_topics"]}
    assert not set(a0) & set(a1) and {**a0, **a1} == ref
