"""run.py's last line of output, its keys and the numbers beside their limits,
from a CPU rehearsal of a whole run with the card's calls stubbed."""

import json

import pytest
import torch

import benchpaths  # noqa: F401  (the benchmark's folder on sys.path)
import run

SMALL = {"block": 38400, "pool_seconds": 0.1, "warmup_blocks": 3, "check_blocks": 2,
         "trace_blocks": 2, "delay_s": 0.5}


@pytest.fixture
def rehearsal(monkeypatch):
    load = run.load_cell

    def small(name):
        bench, cell, cfg, traffic = load(name)
        return bench, cell, cfg, dict(traffic, **SMALL)

    monkeypatch.setattr(run, "load_cell", small)
    monkeypatch.setattr(run, "DEVICE", "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "rehearsal")
    import sdrreceiver_tpu_torch.cuda.build as build

    monkeypatch.setattr(build, "library", lambda: None)


def _run(argv, capsys):
    rc = run.main(argv)
    out, err = capsys.readouterr()
    return rc, json.loads(out.strip().splitlines()[-1]), err.strip().splitlines()


@pytest.mark.parametrize("cell,trace", [("flagship_25e.file_384k", 0),
                                        ("flagship_25e.file_384k", 1),
                                        ("flagship_25e.live_rtltcp", 0)])
def test_last_line(rehearsal, capsys, cell, trace):
    rc, res, err = _run(["--workload", cell, "--seed", str(2**31 + 3), "--seconds", "0.3",
                         "--trace", str(trace)], capsys)
    assert rc == 0
    assert list(res)[:3] == ["correct", "attempted", "failed"] and list(res)[-1] == "checks"
    assert res["correct"] is True and res["attempted"] > 0
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "runtime.host_ms_per_block.file" in res["metrics"]
        assert "throughput_msps" not in res["metrics"]
    else:
        want = {"setup_s"} | ({"throughput_msps"} if "file" in cell else
                              {"latency_p50_ms", "latency_p95_ms"})
        assert set(res["metrics"]) == want
    for v in res["metrics"].values():
        assert set(v) == {"value", "unit"}
    # the compared numbers, each beside its limit, end standard error
    names = list(res["checks"])
    assert err[-len(names):] == [f"check {k} {res['checks'][k]['value']} limit "
                                 f"{res['checks'][k]['limit']}" for k in names]


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "flagship_25e.file_384k", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_jax_loaded_no_result(rehearsal, monkeypatch, capsys):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc = run.main(["--workload", "flagship_25e.file_384k", "--seed", "5", "--seconds", "0.2"])
    out, err = capsys.readouterr()
    assert rc != 0 and out == "" and "jax" in err
