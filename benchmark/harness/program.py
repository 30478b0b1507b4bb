"""Everything the benchmark takes from the program, ``sdrreceiver_tpu_torch``:
the system under test (its receiver, ``run_pipeline`` and the ``run``
command) and the methods its spans wrap.  Nothing else under ``benchmark/``
imports the program.
"""

from __future__ import annotations

import contextlib
import io
import json
import time
from collections import defaultdict

__all__ = ["ini_text", "receiver", "run_pipeline", "run_command", "prebuild", "on_receiver",
           "Spans"]


def ini_text(cfg: dict, zmq_address: str = "", remote_rtl: str = "") -> str:
    """A configuration file as the ini the program reads."""
    lines = [f"sample_rate={cfg['sample_rate']}", f"center_frequency={cfg['center_frequency']}",
             f"correct_dc_bias={int(cfg['correct_dc_bias'])}", f"mix_offset={cfg.get('mix_offset', 0)}"]
    if zmq_address:
        lines.append(f"zmq_address={zmq_address}")
    if remote_rtl:
        lines.append(f"remote_rtl={remote_rtl}")
    lines += ["[main_vfos]", f"size={len(cfg['main_vfos'])}"]
    for i, m in enumerate(cfg["main_vfos"], 1):
        lines += [f"{i}\\frequency={m['frequency']}", f"{i}\\out_rate={m['out_rate']}"]
    lines += ["[vfos]", f"size={len(cfg['vfos'])}"]
    for i, v in enumerate(cfg["vfos"], 1):
        lines += [f"{i}\\{k}={v[k]}" for k in
                  ("frequency", "topic", "gain", "data_rate", "out_rate", "filter_bandwidth")
                  if k in v]
    return "\n".join(lines) + "\n"


def receiver(cfg: dict, block: int, device: str):
    """The receiver ``process-file`` builds: the ini's plan on one device,
    CUDA graphs on the card."""
    from sdrreceiver_tpu_torch.graph.compiler import CompiledReceiver
    from sdrreceiver_tpu_torch.graph.config import parse_ini_text
    from sdrreceiver_tpu_torch.graph.plan import build_plan

    return CompiledReceiver(build_plan(parse_ini_text(ini_text(cfg))), block, device=device)


def run_pipeline(*args, **kwargs):
    from sdrreceiver_tpu_torch.core.runtime import run_pipeline as go

    return go(*args, **kwargs)


def prebuild() -> None:
    """Build (or load) the kernels' and the ingest ring's libraries, so a
    live source never waits for a compiler."""
    import torch

    from sdrreceiver_tpu_torch.io import native

    if torch.cuda.is_available():
        from sdrreceiver_tpu_torch.cuda import build

        build.library()
    native.available()


def run_command(argv: list[str]) -> tuple[int, dict]:
    """The program's CLI in this process: (exit code, its last JSON line)."""
    from sdrreceiver_tpu_torch.cli.main import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main([str(a) for a in argv])
    lines = buf.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if rc == 0 and lines else {})


@contextlib.contextmanager
def on_receiver(fn):
    """Call ``fn(rx)`` on every receiver built inside the block (None: no
    change); the tests' faults break the timed path this way."""
    if fn is None:
        yield
        return
    from sdrreceiver_tpu_torch.graph.compiler import CompiledReceiver

    init = CompiledReceiver.__init__

    def patched(self, *a, **kw):
        init(self, *a, **kw)
        fn(self)

    CompiledReceiver.__init__ = patched
    try:
        yield
    finally:
        CompiledReceiver.__init__ = init


class Spans:
    """Host spans around calls into the program's layers, installed by
    wrapping its methods for the life of a ``with`` block: each call's
    (start, seconds) on ``time.monotonic()`` by span name, in call order.
    A method the program no longer has is skipped, and the metrics that
    read its span find nothing."""

    TARGETS = {
        "step.enqueue": ("sdrreceiver_tpu_torch.graph.compiler", "CompiledReceiver", "step_u8"),
        "runtime.upload": ("sdrreceiver_tpu_torch.core.runtime", None, "_upload"),
        "runtime.fetch_wait": ("sdrreceiver_tpu_torch.core.runtime", "_Fetched", "numpy"),
        "runtime.record_block": ("sdrreceiver_tpu_torch.obs.metrics", "PipelineMetrics",
                                 "record_block"),
        "egress.publish": ("sdrreceiver_tpu_torch.io.zmqpub", "EgressHub", "publish_outputs"),
        "ring.wait": ("sdrreceiver_tpu_torch.io.native.loader", "IngestRing", "pop_raw"),
    }

    def __init__(self, before=None):
        self.calls: dict[str, list[tuple[float, float]]] = defaultdict(list)
        self.args: dict[str, list] = defaultdict(list)  # record_block's seconds
        self._before = before or {}  # span name -> fn(call index) run before the call
        self._undo: list = []

    def __enter__(self) -> "Spans":
        import importlib

        for name, (mod_name, cls_name, attr) in self.TARGETS.items():
            try:
                owner = importlib.import_module(mod_name)
                if cls_name is not None:
                    owner = getattr(owner, cls_name)
                orig = getattr(owner, attr)
            except (ImportError, AttributeError):
                continue
            self._undo.append((owner, attr, orig))
            setattr(owner, attr, self._wrap(name, orig))
        return self

    def _wrap(self, name, orig):
        calls, args, before = self.calls[name], self.args[name], self._before.get(name)

        def wrapped(*a, **kw):
            if before is not None:
                before(len(calls))
            if name == "runtime.record_block" and len(a) > 2:
                args.append(a[2])
            t0 = time.monotonic()
            out = orig(*a, **kw)
            calls.append((t0, time.monotonic() - t0))
            return out

        return wrapped

    def __exit__(self, *exc) -> None:
        for owner, attr, orig in reversed(self._undo):
            setattr(owner, attr, orig)
        self._undo.clear()
