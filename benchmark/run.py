"""Run one cell of the benchmark of ``sdrreceiver_tpu_torch`` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell is an entry of ``BENCHMARK.json``'s
``workloads``; its configuration is the file that entry's config names,
its traffic mix ``benchmark/traffic/<traffic>.json``, whose ``kind`` picks
the driver (``file``: ``harness/filecell.py``, ``live``:
``harness/livecell.py``).  With ``--trace 0`` the result's metrics are the
cell's end-to-end metrics; with ``--trace 1`` its per-layer metrics, each
read by ``benchmark/metrics/<name>.py`` from the traced run.  The last line
of standard output is the result, one JSON object; the numbers that
decided ``correct`` are the last lines of standard error.  Exits non-zero,
with no result, without enough CUDA devices or if the run loaded JAX or
the JAX package.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
DEVICE = "cuda"


def load_cell(name: str) -> tuple[dict, dict, dict, dict]:
    """(BENCHMARK.json, cell, configuration, traffic mix) of cell ``name``."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == name)
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = json.loads((ROOT / entry["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    return bench, cell, cfg, traffic


def applies(metric: dict, cell: str, bench: dict) -> bool:
    """Whether ``metric`` is reported in ``cell``: its ``workloads``; else
    every cell, or for a per-layer metric every cell that reports the
    end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" not in metric:
        return True
    moves = next((m for m in bench["end_to_end"] if m["name"] == metric["moves"]), None)
    return moves is not None and applies(moves, cell, bench)


def read_metric(name: str, trace):
    spec = importlib.util.spec_from_file_location(f"metric_{name.replace('.', '_')}",
                                                  HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(trace)


def settle_host(torch) -> None:
    """A steady host for the program's process: one intra-op thread, and
    the main thread, with every thread it starts later, on the last core
    it may use, once the CUDA context and its threads exist.  The live
    cell's load generator moves itself to the other cores."""
    torch.set_num_threads(1)
    torch.ones(1, device=DEVICE)
    os.sched_setaffinity(0, {max(os.sched_getaffinity(0))})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench, cell, cfg, traffic = load_cell(args.workload)

    # the program's build and kernel caches stay inside the checkout
    cache = ROOT / "build" / "bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: cell {cell['name']} needs {cell['chips']} CUDA device(s), found {n}",
              file=sys.stderr)
        return 2
    if DEVICE == "cuda":
        settle_host(torch)
    sys.path.insert(1, str(ROOT))
    from harness import check, filecell, livecell, nojax

    driver = {"file": filecell, "live": livecell}[traffic["kind"]]
    out = driver.run(cfg, traffic, args.seed, args.seconds, bool(args.trace), DEVICE, T_START)
    bad = nojax.loaded()
    if bad:
        print(f"benchmark: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3

    result = {"correct": False, "attempted": out["attempted"], "failed": out["failed"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": int(cell["chips"]), "memory_peak_bytes": int(out["memory_peak_bytes"])}
    metrics = {}
    if args.trace:
        t = out["trace"]
        for m in bench["per_layer"]:
            if applies(m, cell["name"], bench):
                v = read_metric(m["name"], t)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device.update(busy_s=t.busy_s, window_s=t.window_s)
    else:
        for m in bench["end_to_end"]:
            if applies(m, cell["name"], bench) and m["name"] in out["e2e"]:
                metrics[m["name"]] = {"value": out["e2e"][m["name"]], "unit": m["unit"]}
    result.update(metrics=metrics, device=device)
    if args.trace:
        result["breakdown"] = out["trace"].breakdown()
    print(json.dumps({"diag": {k: v for k, v in out.items() if k not in ("trace", "numbers")},
                      "numbers": out["numbers"]}), file=sys.stderr)
    correct, checks = check.verdict(out["numbers"])
    result["correct"] = correct
    result["checks"] = checks
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
