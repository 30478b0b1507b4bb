"""The port's io, checkpoint, metrics and CLI vs the JAX package's.

Host modules are compared byte for byte; the two CLIs are run in this
process on the same files: ``synth`` output byte-equal, ``plan`` JSON equal,
``process-file`` audio within 1 LSB (``--device cpu`` against
``--backend cpu``), and a ``--save-state`` from either CLI resumes with
``--resume`` in the other.  Runs on the CPU.
"""

import json
import socket
import struct
import time

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from sdrreceiver_tpu.cli.main import main as jmain
from sdrreceiver_tpu.core import checkpoint as jcheckpoint
from sdrreceiver_tpu.graph import build_plan as jbuild_plan
from sdrreceiver_tpu.graph import parse_ini_text as jparse
from sdrreceiver_tpu.graph.compiler import CompiledReceiver as JaxReceiver
from sdrreceiver_tpu.io import iqfile as jiqfile
from sdrreceiver_tpu.io import wavout as jwavout
from sdrreceiver_tpu.io import zmqpub as jzmqpub
from sdrreceiver_tpu.obs import metrics as jmetrics
from sdrreceiver_tpu_torch.cli.main import main
from sdrreceiver_tpu_torch.core import checkpoint
from sdrreceiver_tpu_torch.flagship import benchmark_config
from sdrreceiver_tpu_torch.graph.compiler import CompiledReceiver
from sdrreceiver_tpu_torch.graph.config import parse_ini_text
from sdrreceiver_tpu_torch.graph.plan import build_plan
from sdrreceiver_tpu_torch.io import iqfile, wavout, zmqpub
from sdrreceiver_tpu_torch.obs import metrics
from test_torch_altrate import PLANS
from test_torch_modules import _to_ini

# six xdist workers share the machine's cores: a few torch threads each
torch.set_num_threads(2)

BLOCK = 153600  # a multiple of both alt-rate plans' divisors
INIS = {**{k: v[0] for k, v in PLANS.items()}, "flagship": _to_ini(graft._benchmark_config())}


def _plans(name):
    return build_plan(parse_ini_text(INIS[name])), jbuild_plan(jparse(INIS[name]))


# ------------------------------------------------------------------ io
@pytest.mark.parametrize("fmt", ["u8", "cf32"])
def test_write_and_read_iq_byte_equal(tmp_path, rng, fmt):
    iq = (rng.standard_normal(5001) * 60 + 1j * rng.standard_normal(5001) * 60).astype(np.complex64)
    iq[:4] = [200 + 0j, -200j, 0.5 + 0.5j, -0.5 - 0.5j]  # clipped, and ties
    iqfile.write_iq(tmp_path / "ours", iq, fmt)
    jiqfile.write_iq(tmp_path / "ref", iq, fmt)
    assert (tmp_path / "ours").read_bytes() == (tmp_path / "ref").read_bytes()
    for p in ("ours", "ref"):
        a, b = iqfile.read_iq(tmp_path / p, fmt), jiqfile.read_iq(tmp_path / p, fmt)
        assert a.dtype == b.dtype == np.complex64
        np.testing.assert_array_equal(a, b)  # exact
    with pytest.raises(ValueError, match="unknown IQ format"):
        iqfile.read_iq(tmp_path / "ours", "s16")


@pytest.mark.parametrize("pad_final", [False, True])
def test_iter_blocks_equal(pad_final):
    x = np.arange(1003, dtype=np.complex64)
    ours = list(iqfile.iter_blocks(x, 250, pad_final))
    ref = list(jiqfile.iter_blocks(x, 250, pad_final))
    assert len(ours) == len(ref) == 4 + pad_final
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)


def test_write_wav_byte_equal(tmp_path, rng):
    pcm = rng.integers(-32768, 32768, 4801).astype(np.int16)
    wavout.write_wav(tmp_path / "a.wav", pcm, 12000)
    jwavout.write_wav(tmp_path / "b.wav", pcm, 12000)
    assert (tmp_path / "a.wav").read_bytes() == (tmp_path / "b.wav").read_bytes()


@pytest.mark.parametrize("topic", ["VFO01", "AB", "ABCDEFG"])
def test_pack_frames_equal(topic):
    payload = np.arange(7, dtype=np.int16).tobytes()
    assert zmqpub.pack_frames(topic, 48000, payload) == jzmqpub.pack_frames(topic, 48000, payload)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_egress_hub_routes_audio_and_iq():
    """Audio to the bound PUB socket, IQ to the group's connect-mode
    socket; a SUB on each receives the 3 wire frames."""
    import zmq

    ctx = zmq.Context()
    iq_sub = ctx.socket(zmq.SUB)
    iq_port = iq_sub.bind_to_random_port("tcp://127.0.0.1")
    audio_port = _free_port()
    text = (PLANS["iq"][0]
            .replace("tcp://*:6003", f"tcp://127.0.0.1:{audio_port}")
            .replace("tcp://127.0.0.1:7777", f"tcp://127.0.0.1:{iq_port}"))
    hub = zmqpub.EgressHub(build_plan(parse_ini_text(text)), context=ctx)
    audio_sub = ctx.socket(zmq.SUB)
    audio_sub.connect(f"tcp://127.0.0.1:{audio_port}")
    for s in (iq_sub, audio_sub):
        s.setsockopt(zmq.SUBSCRIBE, b"")
    try:
        outs = {"audio/VFO13": np.arange(6, dtype=np.int16),
                "iq/IQFWD": np.arange(5, dtype=np.uint8), "tap/main": np.zeros((2, 4))}
        got = {}
        deadline = time.monotonic() + 10
        while len(got) < 2 and time.monotonic() < deadline:  # slow joiners
            assert hub.publish_outputs(outs) == 2
            for s in (iq_sub, audio_sub):
                if s.poll(100):
                    f = s.recv_multipart()
                    got[f[0]] = f
        assert got[b"VFO13"][1:] == [struct.pack("<I", 48000), outs["audio/VFO13"].tobytes()]
        assert got[b"IQFWD"][1:] == [struct.pack("<I", 192000), outs["iq/IQFWD"].tobytes()]
        assert hub.rates == {"audio/VFO01": 12000, "audio/VFO02": 12000,
                             "audio/VFO13": 48000, "iq/IQFWD": 192000}
    finally:
        hub.close()
        iq_sub.close(linger=0)
        audio_sub.close(linger=0)
        ctx.term()


# ------------------------------------------------- checkpoint, metrics
@pytest.mark.parametrize("name", sorted(INIS))
def test_plan_fingerprint_and_cost_model_equal(name):
    plan, jplan = _plans(name)
    assert checkpoint.plan_fingerprint(plan) == jcheckpoint.plan_fingerprint(jplan)
    assert metrics.plan_cost_model(plan) == jmetrics.plan_cost_model(jplan)
    assert metrics.plan_cost_model(plan, BLOCK) == jmetrics.plan_cost_model(jplan, BLOCK)
    assert metrics.group_cost_model(plan) == jmetrics.group_cost_model(jplan)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_npz_files_cross(tmp_path, direction):
    plan, jplan = _plans("alt")
    rx, jrx = CompiledReceiver(plan, BLOCK, device="cpu"), JaxReceiver(jplan, BLOCK)
    raw = np.random.default_rng(2).integers(0, 256, 2 * BLOCK).astype(np.uint8)
    if direction == "jax_to_port":
        s, _ = jrx.step_u8(jrx.init_state(), raw)
        named = jrx.export_state(s)
        jcheckpoint.save_state(tmp_path / "s.npz", named, jplan)
        back = rx.export_state(rx.import_state(checkpoint.load_state(tmp_path / "s.npz", plan)))
    else:
        s, _ = rx.step_u8(rx.init_state(), torch.from_numpy(raw))
        named = rx.export_state(s)
        checkpoint.save_state(tmp_path / "s.npz", named, plan)
        back = jrx.export_state(jrx.import_state(jcheckpoint.load_state(tmp_path / "s.npz", jplan)))
    assert set(back) == set(named)
    for k in named:
        np.testing.assert_array_equal(back[k], named[k])  # exact
    with pytest.raises(ValueError, match="fingerprint"):
        checkpoint.load_state(tmp_path / "s.npz", _plans("192")[0])


# ---------------------------------------------------------------- CLI
@pytest.fixture(scope="module")
def altrate(tmp_path_factory):
    """The alt-rate ini and a 4-block u8 recording made by the JAX synth;
    its halves (blocks 1-2, 3-4) as files of their own."""
    d = tmp_path_factory.mktemp("alt")
    ini = d / "alt.ini"
    ini.write_text(INIS["alt"])
    f = d / "alt.u8"
    assert jmain(["synth", "-s", str(ini), "--out", str(f), "--seconds", "0.32",
                  "--amplitude", "1", "--noise", "0.5",
                  "--only", "AL000,AL002,AH000,AH002"]) == 0
    raw = np.fromfile(f, np.uint8)
    assert raw.size == 4 * 2 * BLOCK
    (d / "head.u8").write_bytes(raw[: 4 * BLOCK].tobytes())
    (d / "tail.u8").write_bytes(raw[4 * BLOCK :].tobytes())
    return d


def _audio(outdir) -> dict[str, np.ndarray]:
    return {p.stem: np.fromfile(p, np.int16) for p in sorted(outdir.glob("audio_*.s16"))}


def _close(ours: dict, ref: dict, tail: bool = False):
    """<= 1 LSB, flip rate < 1e-3 pooled; ``tail`` compares with the end
    of each reference stream."""
    assert set(ours) == set(ref) and ours
    flips = total = 0
    for k, r in ref.items():
        r = r[-ours[k].size :] if tail else r
        assert ours[k].shape == r.shape, k
        d = np.abs(ours[k].astype(np.int32) - r)
        assert d.max() <= 1, (k, int(d.max()))
        flips, total = flips + int((d > 0).sum()), total + d.size
    assert flips / total < 1e-3, flips / total


def test_synth_byte_equal(tmp_path, capsys, altrate):
    ini = str(altrate / "alt.ini")
    args = ["synth", "-s", ini, "--seconds", "0.05", "--amplitude", "3", "--noise", "0.7",
            "--dc", "2", "--only", "AL001,AH002"]
    for fmt in ("u8", "cf32"):
        assert main([*args, "--out", str(tmp_path / f"o.{fmt}"), "--format", fmt]) == 0
        ours = capsys.readouterr().out
        assert jmain([*args, "--out", str(tmp_path / f"r.{fmt}"), "--format", fmt]) == 0
        ref = capsys.readouterr().out
        assert json.loads(ours) == dict(json.loads(ref), out=str(tmp_path / f"o.{fmt}"))
        assert (tmp_path / f"o.{fmt}").read_bytes() == (tmp_path / f"r.{fmt}").read_bytes()


@pytest.mark.parametrize("name", sorted(INIS))
def test_plan_json_equal(tmp_path, capsys, name):
    ini = tmp_path / "p.ini"
    ini.write_text(INIS[name])
    assert main(["plan", "-s", str(ini)]) == 0
    ours = capsys.readouterr().out
    assert jmain(["plan", "-s", str(ini)]) == 0
    assert json.loads(ours) == json.loads(capsys.readouterr().out)


def _process(cli, ini, iq, out, *extra):
    dev = ["--device", "cpu"] if cli is main else ["--backend", "cpu"]
    return cli(["process-file", "-s", str(ini), "--iq", str(iq), "--out", str(out),
                "--block", str(BLOCK), *dev, *extra])


@pytest.fixture(scope="module")
def jax_straight(altrate):
    out = altrate / "jax_straight"
    assert _process(jmain, altrate / "alt.ini", altrate / "alt.u8", out) == 0
    return _audio(out)


def test_process_file_audio_matches_jax_cli(tmp_path, capsys, altrate, jax_straight):
    assert _process(main, altrate / "alt.ini", altrate / "alt.u8", tmp_path / "o",
                    "--wav", "--spectrum", "main") == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["blocks"] == 4 and summary["device"] == "cpu"
    assert "spectrum_main.npy" in summary["outputs_written"]
    ours = _audio(tmp_path / "o")
    assert len(ours) == 6 and all(v.size == 4 * BLOCK // 160 * (4 if "AH" in k else 1)
                                  for k, v in ours.items())
    _close(ours, jax_straight)
    spec = np.load(tmp_path / "o" / "spectrum_main.npy")
    assert spec.shape == (8182,) and np.isfinite(spec).all()


@pytest.mark.parametrize("first", ["jax", "port"])
def test_save_state_resumes_across_clis(tmp_path, altrate, jax_straight, first):
    """Blocks 1-2 in one CLI with --save-state, blocks 3-4 in the other
    with --resume: the straight JAX run's last two blocks, within 1 LSB."""
    a, b = (jmain, main) if first == "jax" else (main, jmain)
    ini, ck = altrate / "alt.ini", tmp_path / "s.npz"
    assert _process(a, ini, altrate / "head.u8", tmp_path / "h", "--save-state", str(ck)) == 0
    assert _process(b, ini, altrate / "tail.u8", tmp_path / "t", "--resume", str(ck)) == 0
    tail = _audio(tmp_path / "t")
    _close(tail, jax_straight, tail=True)


@pytest.mark.parametrize(
    "extra", [["--mesh", "2x1"], ["--coordinator", "127.0.0.1:{port}"], ["--partition", "global"]],
    ids=["mesh", "coordinator", "partition_global"],
)
def test_dist_options_exit_1(tmp_path, altrate, capsys, jax_straight, extra):
    """``process-file`` with a 2x1 mesh of CPU devices, with a coordinator
    and a process group of one, and with ``--partition global`` in one
    process: each exits 0 with the straight JAX run's audio, within 1 LSB."""
    extra = [e.format(port=_free_port()) for e in extra]
    assert _process(main, altrate / "alt.ini", altrate / "alt.u8", tmp_path / "x", *extra) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["blocks"] == 4 and summary["device"] == "cpu"
    assert ("multihost" in summary) == ("--coordinator" in extra)
    _close(_audio(tmp_path / "x"), jax_straight)


@pytest.mark.parametrize(
    "mesh,partition", [("4by2", "groups"), ("0x2", "groups"), ("4by2", "global")],
    ids=["not_txc", "zero_shards", "global_not_txc"],
)
def test_bad_mesh_form_exits_1_like_jax(altrate, capsys, mesh, partition):
    """A ``--mesh`` that is not TxC exits 1 with the JAX CLI's message: the
    JAX CLI run on the same arguments where no process group is needed,
    else its text.  No shard count may be 0."""
    extra = ["--mesh", mesh]
    if partition == "global":
        extra += ["--coordinator", f"127.0.0.1:{_free_port()}", "--partition", "global"]
    assert _process(main, altrate / "alt.ini", altrate / "alt.u8", altrate / "bad", *extra) == 1
    err = capsys.readouterr().err.strip().splitlines()[-1]
    if partition == "global":
        assert err == f"--mesh wants TxC, got {mesh!r}"
    elif mesh == "0x2":
        assert err == f"--mesh wants TxC (e.g. 4x2), got {mesh!r}"
    else:
        with pytest.raises(SystemExit) as e:
            _process(jmain, altrate / "alt.ini", altrate / "alt.u8", altrate / "bad", *extra)
        assert err == e.value.code
    assert not (altrate / "bad").exists()


def test_device_cuda_without_card_exits_1(altrate, capsys):
    """Decided inside the test: on a machine with a card there is nothing
    to show here."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc = main(["process-file", "-s", str(altrate / "alt.ini"), "--iq", str(altrate / "alt.u8"),
               "--out", str(altrate / "y"), "--device", "cuda"])
    assert rc == 1
    assert "CUDA is not available" in capsys.readouterr().err
    assert not (altrate / "y").exists()  # nothing ran on the CPU instead


def test_flagship_ini_round_trips():
    assert _to_ini(benchmark_config()) == INIS["flagship"]
