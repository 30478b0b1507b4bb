"""A run whose timed path is broken underneath comes out not correct: the
harness's drivers with the program's receiver broken in each way this cell
can break, on the CPU at a small block and on the card at each cell's own
block.  The sound run is correct."""

import json
import time

import pytest
import torch
from torch.utils import _pytree

from benchpaths import HERE
import run
from harness import check, filecell, livecell

CFG = json.loads((HERE / "configs" / "flagship_25e.json").read_text())
SMALL = {"block": 38400, "pool_seconds": 0.1, "warmup_blocks": 3, "check_blocks": 3}
CELLS = [w["name"] for w in json.loads((HERE.parent / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    """The card's device name; skips the test on a machine without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def _clone(state):
    return _pytree.tree_map(lambda v: v.clone() if isinstance(v, torch.Tensor) else v, state)


def _state_unchanged(rx):
    """A step that returns its state unchanged: every block starts from the
    state the first block started from (a copy, so that a step that writes
    its state in place, as a CUDA graph's replay does, cannot move it)."""
    step = rx.step_u8
    kept = []

    def broken(state, raw):
        if not kept:
            kept.append(_clone(state))
        return kept[0], step(_clone(kept[0]), raw)[1]

    rx.step_u8 = broken


def _outputs(change):
    def fault(rx):
        step = rx.step_u8

        def broken(state, raw):
            state, outs = step(state, raw)
            return state, {k: change(v.clone()) if k.startswith("pcm/") else v
                           for k, v in outs.items()}

        rx.step_u8 = broken
    return fault


def _half(v):
    """Half of the batch left out: the second half of each bucket's
    channels never computed."""
    v[len(v) // 2:] = 0
    return v


def _altered(v):
    """One answer altered where it is produced: a bit of one sample flipped."""
    v[7] ^= 64
    return v


FAULTS = {"sound": None, "state_unchanged": _state_unchanged, "half_batch": _outputs(_half),
          "altered_sample": _outputs(_altered)}


def _file(fault):
    tr = dict(json.loads((HERE / "traffic" / "file_384k.json").read_text()), **SMALL)
    return filecell.run(CFG, tr, 2**31 + 99, 1.0, False, "cpu", time.monotonic(), fault)


def _live(fault):
    tr = dict(json.loads((HERE / "traffic" / "live_rtltcp.json").read_text()), **SMALL)
    tr["delay_s"] = 0.5
    return livecell.run(CFG, tr, 2**31 + 98, 0.2, False, "cpu", time.monotonic(), fault)


@pytest.mark.parametrize("name", sorted(FAULTS))
def test_file_cell(name):
    out = _file(FAULTS[name])
    correct, _ = check.verdict(out["numbers"])
    assert correct is (name == "sound"), out["numbers"]
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("name", sorted(FAULTS))
def test_live_cell(name):
    torch.set_num_threads(2)
    out = _live(FAULTS[name])
    correct, _ = check.verdict(out["numbers"])
    assert correct is (name == "sound"), out["numbers"]
    assert out["attempted"] == 27 * 8 and out["failed"] == 0, {  # 0.2 s of 38,400-sample blocks
        k: v for k, v in out.items() if k not in ("trace", "numbers")}


@pytest.mark.parametrize("name", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_faults_at_the_cells_block_on_the_card(card, cell, name):
    """Each fault once a cell, at the cell's own traffic and block, with a
    short window; the numbers go to standard output for PERF.md."""
    _, _, cfg, traffic = run.load_cell(cell)
    driver = {"file": filecell, "live": livecell}[traffic["kind"]]
    out = driver.run(cfg, traffic, 2**31 + 501, 3.0, False, card, time.monotonic(),
                     FAULTS[name])
    correct, _ = check.verdict(out["numbers"])
    print(json.dumps({"cell": cell, "fault": name, "correct": correct, **out["numbers"]}))
    assert correct is (name == "sound"), out["numbers"]
