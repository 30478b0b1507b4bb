"""The control (the reference in TF32 in the program's place) comes out not
correct: at a small block here, at each cell's own size on the card."""

import json

import pytest
import torch

import benchpaths  # noqa: F401  (the benchmark's folder on sys.path)
import control
import run
from harness import check


@pytest.fixture
def card():
    """The card's device name; skips the test on a machine without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.parametrize("config,block", [("flagship_25e", 38400), ("altrate_54w", 48000)])
def test_control_fails_small(config, block):
    bench, cell, cfg, traffic = run.load_cell(next(
        w["name"] for w in json.loads((run.ROOT / "BENCHMARK.json").read_text())["workloads"]
        if w["config"] == config))
    traffic = dict(traffic, block=block, pool_seconds=0.1, warmup_blocks=1, check_blocks=2)
    for seed in (1, 2, 2**31 + 7):
        nums = control.readings(cfg, traffic, seed, "cpu")
        assert check.verdict(nums)[0] is False, nums


@pytest.mark.parametrize("cell", [w["name"] for w in json.loads(
    (run.ROOT / "BENCHMARK.json").read_text())["workloads"]])
def test_control_fails_on_the_card(card, cell):
    _, _, cfg, traffic = run.load_cell(cell)
    for seed in (11, 12, 13):
        assert check.verdict(control.readings(cfg, traffic, seed, card))[0] is False
