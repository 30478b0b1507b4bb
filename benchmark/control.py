"""The control of the comparison that decides ``correct``: the reference in
TF32, the precision below the float32-with-TF32-off the program computes
in, put in the program's place.  It must come out not correct.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3

For each seed it makes the cell's recording, draws as many blocks as a run
compares, and compares the control's audio with the reference's as a run
compares the program's; one JSON line per seed with the numbers, then the
smallest reading of each over the seeds.  The benchmark's runs never run it.
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent


def readings(cfg: dict, traffic: dict, seed: int, device: str) -> dict:
    import numpy as np

    from harness import check, gen
    from reference.receiver import Reference

    block = int(traffic["block"])
    n_pool = max(1, math.ceil(traffic["pool_seconds"] * cfg["sample_rate"] / block))
    pool = gen.recording(cfg, block, n_pool, seed, device)
    ref = Reference(cfg, pool, device)
    ctl = Reference(cfg, pool, device, precision="tf32")
    warm = int(traffic["warmup_blocks"])
    rng = np.random.default_rng([seed, 17])
    tally = check.Tally()
    for b in sorted(rng.choice(range(warm, warm + 4 * n_pool), int(traffic["check_blocks"]),
                               replace=False)):
        tally.compare(ctl.audio(int(b)), ref.audio(int(b)))
    return tally.numbers()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    import run
    from harness import check

    _, cell, cfg, traffic = run.load_cell(args.workload)
    rows = []
    for seed in args.seeds:
        nums = readings(cfg, traffic, seed, args.device)
        correct, _ = check.verdict(nums)
        rows.append(nums)
        print(json.dumps({"workload": cell["name"], "seed": seed, "correct": correct, **nums}),
              flush=True)
    print(json.dumps({"workload": cell["name"], "least": {
        k: min(r[k] for r in rows) for k in ("max_lsb", "flip_share")}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
