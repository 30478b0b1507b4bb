"""Plan -> CompiledReceiver: the whole receiver as one block step on tensors.

Port of ``sdrreceiver_tpu.graph.compiler`` for one device:

    u8 (or f32) ingest + DC  ->  group fronts (mix + half-band cascade)
        ->  [compressed group IQ]
        ->  per bucket: mix + cascade  ->  late /5 /6  ->  USB demod
        ->  audio LPF (direct, or overlap-save FFT for long filters)
        ->  int16 quantize

``state', outputs = rx.step_u8(state, raw)``.  The DC pass runs in the fused
ingest+DC kernel (``cuda/dckernel.py``) and every cascaded mix in the
mix-cascade kernel (``cuda/frontend.py``): one merged kernel call for all
group fronts when two or more groups cascade, then one per bucket.  The rest
is torch ops.  On CPU tensors the kernel wrappers run their plain versions;
``use_kernels=False`` calls the plain versions on any device (the reference
the kernels are held to on the card).  On the card each step entry and each
burst runs as one captured CUDA graph (``cudagraph.py``), the counterpart of
the JAX package's one executable per entry; the state passed in is donated.

The mix-cascade kernel is stateless: each call is prefixed with the stream's
past (the carried post-DC input tail ``xtail`` for group fronts, the
previous block's group output re-derived from it for buckets) and the
warm-up outputs dropped; the canonical per-stage cascade histories are then
re-derived from the block's tail.  So the state stays in the JAX package's
canonical layout, and :meth:`export_state` / :meth:`import_state` cross
checkpoints both ways.  The group fronts take the block as a list of time
shards, one here; ``dist.ShardedReceiver`` supplies several, with their
halos and gathers (:meth:`_left_halos`, :meth:`_gather_time`,
:meth:`_stateful_group`, :meth:`_input_tail`).

A block shorter than the kernels' warm-up has no carried ``xtail`` (the
JAX package's rule, so both packages' states keep one layout): there every
group and bucket runs the stateful path instead, the NCO mix then the
half-band cascade on its carried ``cascade`` histories, as the JAX package
does at such blocks.  The choice is made at construction from the plan and
the block; the DC kernel runs at every block.

Scope taps (``emit_taps``) add ``tap/<name>`` outputs: the post-DC input
("main"), a group's output ("g<i>") or a sub-VFO's decimated pre-late
baseband (its topic).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..core import stream
from ..cuda.dckernel import DcIngest
from ..cuda.frontend import MixCascade, phase_back, warmup_len
from ..kernels import (
    compress,
    dc,
    design,
    fir,
    halfband,
    ingest,
    nco,
    ossfft,
    polyphase,
    usbdemod,
)
from .cudagraph import StepGraphs, flatten, run_burst
from .plan import ReceiverPlan

__all__ = ["CompiledReceiver"]


def _layout_warmup(stages: int, data_len: int, fs: int, base: int | None = None) -> int:
    """The JAX package's ``pick_warmup`` (with its ``_tiling`` and
    ``supported``): the warm-up padded by whole 256-sample rows until the
    TPU kernel's tiling accepts ``data_len + warm``.  Shape-only; used to
    size the carried ``xtail`` exactly as the JAX package does, so the two
    packages' states have one layout.  The port's kernels need only
    :func:`warmup_len`."""

    def rows_per_tile(t: int) -> int | None:  # None: the TPU kernel refuses t
        if stages > 7 or t % 256:
            return None
        total = t // 256
        r = next(
            (c for c in (512, 480, 448, 400, 384, 320, 256, 240, 192, 128,
                         96, 64, 48, 32, 16, 8) if total % c == 0),
            total,
        )
        if fs * max(r, 256) >= 2**31 or (total // r) * fs >= 2**31:
            return None
        return None if fs * 2048 >= 2**32 else r

    if base is None:
        base = warmup_len(stages)
    fallback = None
    for extra in range(65):
        warm = base + extra * 256
        t = data_len + warm
        if t % 256:
            break
        r = rows_per_tile(t)
        if r is None:
            continue
        if fallback is None:
            fallback = warm
        if r == t // 256 or r >= 32:
            return warm
    return base if fallback is None else fallback


def _is_planar_pair(key: str) -> bool:
    """State paths held as planar ``[2, ...]`` f32 whose canonical
    (checkpoint) form is complex64: the DC mean, the input tail, cascade
    stage histories and late-decimator histories."""
    leaf = key.rsplit("/", 1)[-1]
    return key in ("dc", "xtail") or leaf == "late" or (
        "/cascade/" in key and leaf.isdigit()
    )


class CompiledReceiver:
    """Executable form of a ReceiverPlan on one device.

    Outputs of one step (the JAX package's keys and layouts):
      ``pcm/g<i>/b<j>``  int16 ``[C*T_audio]``, one bucket's audio,
                         channel-major; :meth:`split_audio` gives the
                         per-topic ``audio/<topic>`` views
      ``iq/<topic>``     uint8 ``[T_group]`` compressed group IQ, for main
                         VFOs that publish it (mainwindow.cpp:109-126)
      ``tap/<name>``     f32 ``[2, T']`` planar scope tap, the last
                         ``tap_samples`` samples (for each ``emit_taps``)

    State is a nested dict of tensors on ``device``, the card by default:
    ``device="cuda"`` without a CUDA device raises, and the CPU runs only
    when asked for (``device="cpu"``).  ``use_kernels=False`` runs the kernels'
    plain versions on any device.  Audio filters of at least
    ``ossfft_min_taps`` taps run through the overlap-save FFT engine
    (``kernels/ossfft``; None disables it).

    ``cuda_graphs`` (on the card): each step and burst entry captures its
    work as one CUDA graph on its first call and replays it from then on
    (:class:`~.cudagraph.StepGraphs`).  The state is then donated as in the
    JAX package: a step consumes the state passed to it and returns the
    receiver's own state buffers, updated in place, so a caller that needs
    a state later exports or clones it first.  Outputs stay valid after
    later steps.  ``cuda_graphs=False`` runs the step eagerly (for A/B
    timing).  The plain versions synchronise with the host and cannot be
    captured: ``use_kernels=False`` needs ``cuda_graphs=False`` and runs
    eagerly.  On the CPU the step is eager."""

    # one device computes the block as one time shard; dist.ShardedReceiver
    # sets its mesh and its time-shard count, and its graphs per phase
    mesh = None
    n_time = 1
    _graphs_type = StepGraphs

    def __init__(
        self,
        plan: ReceiverPlan,
        block_samples: int | None = None,
        emit_taps: tuple[str, ...] = (),
        device: torch.device | str = "cuda",
        use_kernels: bool = True,
        ossfft_min_taps: int | None = 128,
        tap_samples: int | None = 8192,
        cuda_graphs: bool = True,
    ):
        self.plan = plan
        self.block = int(block_samples or plan.block_samples)
        self.emit_taps = tuple(emit_taps)
        self.ossfft_min_taps = ossfft_min_taps
        self.tap_samples = tap_samples
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "CompiledReceiver: device 'cuda' requested but CUDA is not available"
                )
            if self.device.index is None:
                self.device = torch.device("cuda", torch.cuda.current_device())
        elif self.device.type != "cpu":
            raise ValueError(f"CompiledReceiver: unsupported device {self.device}")
        self.use_kernels = bool(use_kernels)
        self.cuda_graphs = bool(cuda_graphs)
        if self.cuda_graphs and not self.use_kernels:
            raise ValueError(
                "cuda_graphs=True needs use_kernels=True: the plain versions synchronise "
                "with the host; pass cuda_graphs=False to run them"
            )
        bad = set(self.emit_taps) - set(self.tap_rates())
        if bad:
            raise ValueError(f"unknown taps {sorted(bad)}; valid: {sorted(self.tap_rates())}")
        div = plan.block_divisor()
        if self.block % div:
            raise ValueError(
                f"block of {self.block} samples not a multiple of chain divisor {div}"
            )
        self._build_consts()
        use_graphs = self.cuda_graphs and self.device.type == "cuda"
        self._graphs = self._graphs_type(self) if use_graphs else None

    # ------------------------------------------------------------ checks
    def _check_input(self, raw: torch.Tensor, dtype: torch.dtype, n: int,
                     burst: bool = False) -> None:
        """``raw`` is ``[n]`` (a burst: ``[k, n]``, k >= 1) of ``dtype`` on
        the receiver's device."""
        shape = (raw.shape[:1] if burst else ()) + (n,)
        if raw.device != self.device or raw.dtype != dtype or raw.shape != shape or 0 in shape:
            want = f"[k, {n}]" if burst else f"[{n}]"
            raise ValueError(
                f"expected {dtype} {want} on {self.device}, got {raw.dtype} "
                f"{tuple(raw.shape)} on {raw.device}"
            )

    # ------------------------------------------------------------ consts
    def _build_consts(self) -> None:
        dev = self.device
        plan = self.plan
        self.dc_ingest = DcIngest()
        hb = design.half_band(11)
        hilb = design.hilbert()
        self._hb1 = fir.prepare_taps(hb, 1, dev)
        self._c: dict[str, torch.Tensor] = {}
        self._oss: dict[str, dict] = {}
        # each IQ-forwarding group's compression divisor, built once
        self._iq_scale = {g.index: compress.scale_tensor(g.compress_scale, dev)
                          for g in plan.groups if g.publishes_iq}
        self._build_kernels()
        for g in plan.groups:
            for bi, b in enumerate(g.buckets):
                bk = f"g{g.index}/b{bi}"
                c = b.channels
                self._c[f"{bk}/hb"] = fir.prepare_taps(hb, c, dev)
                self._c[f"{bk}/hilbert"] = fir.prepare_taps(hilb, c, dev)
                self._c[f"{bk}/gains"] = torch.tensor(b.gains(), device=dev)
                lt = b.late_taps()
                if lt is not None:
                    self._c[f"{bk}/late"] = fir.prepare_taps(lt, c, dev)
                at = b.audio_taps()
                if at is None:
                    continue
                if self.ossfft_min_taps is not None and at.shape[1] >= self.ossfft_min_taps:
                    self._oss[bk] = ossfft.oss_prepare(at, device=dev)
                else:
                    self._c[f"{bk}/audio"] = fir.prepare_taps(at, None, dev)

    def _shard_devices(self) -> list[tuple[int, torch.device]]:
        """(index, device) of each time shard of the block this process
        computes: on one device, the whole block."""
        return [(0, self.device)]

    def _build_kernels(self) -> None:
        """The mix-cascade kernel wrappers: the group fronts, one wrapper
        per time shard, and on one device the buckets.  The stateless
        kernels warm up from the carried xtail (or the left neighbour's
        shard); without one, and for a shard shorter than the warm-up, the
        stateful path runs."""
        plan = self.plan
        tail = self.xtail_len()
        t_local = self.block // self.n_time
        cands = [g for g in plan.groups if not g.direct and g.stages >= 1] if tail else []

        def warmup(gs) -> int | None:
            p = max(warmup_len(g.stages) for g in gs)
            return p if p <= min(t_local, tail) else None

        # one kernel call for every group front when two or more cascade:
        # they all mix the SAME full-rate stream, read once per tile
        sets = [cands] if len(cands) >= 2 and warmup(cands) else [[g] for g in cands]
        # (one wrapper per shard, warm-up length, group indices)
        self._fronts: list[tuple[list[MixCascade], int, list[int]]] = []
        for gs in sets:
            p = warmup(gs)
            if p is not None:
                self._fronts.append((
                    [MixCascade([g.stages for g in gs], plan.fs, [g.mixer_freq for g in gs], dev)
                     for _, dev in self._shard_devices()],
                    p, [g.index for g in gs],
                ))
        self._bucket_mc: dict[str, MixCascade] = {}
        if self.mesh is not None:
            return  # buckets run the stateful path under a mesh, as in the JAX package
        for g in plan.groups:
            for bi, b in enumerate(g.buckets):
                if tail and b.stages >= 1:
                    self._bucket_mc[f"g{g.index}/b{bi}"] = MixCascade(
                        [b.stages] * b.channels, b.mix_fs(g.out_rate), b.mixer_freqs(),
                        self.device,
                    )

    def mix_cascades(self) -> dict[str, tuple[MixCascade, int]]:
        """Every mix-cascade kernel wrapper this receiver launches, by site
        ("front" for the merged group fronts, "g<i>" or "g<i>/b<j>"; under a
        mesh "shard<i>/front" or "shard<i>/g<k>"), with the input length
        each call gets (block or shard, plus warm-up)."""
        t_local = self.block // self.n_time
        sites = {}
        for kerns, p, gidxs in self._fronts:
            name = "front" if len(gidxs) >= 2 else f"g{gidxs[0]}"
            for (i, _), mc in zip(self._shard_devices(), kerns):
                sites[name if self.mesh is None else f"shard{i}/{name}"] = (mc, t_local + p)
        for g in self.plan.groups:
            for bi, b in enumerate(g.buckets):
                mc = self._bucket_mc.get(f"g{g.index}/b{bi}")
                if mc is not None:
                    sites[f"g{g.index}/b{bi}"] = (
                        mc, (self.block >> g.stages) + warmup_len(b.stages)
                    )
        return sites

    def _run(self, kern, *args):
        return kern(*args) if self.use_kernels else kern.plain(*args)

    # ------------------------------------------------------------- state
    def xtail_len(self) -> int:
        """Length of the carried post-DC input tail ``state["xtail"]``: the
        JAX package's value for the same plan and block (its TPU-tiled
        warm-ups), so checkpoints cross unchanged.  It covers every
        warm-up this port prepends.  0 = no tail."""
        ps = []
        cands = [g for g in self.plan.groups if not g.direct and g.stages >= 1]
        if len(cands) >= 2:
            ps.append(_layout_warmup(
                max(g.stages for g in cands), self.block, self.plan.fs,
                base=max(warmup_len(g.stages) for g in cands),
            ))
        for g in cands:
            ps.append(_layout_warmup(g.stages, self.block, self.plan.fs))
        for g in self.plan.groups:
            wg_washout = warmup_len(g.stages) if g.stages >= 1 else 0
            tg = self.block >> g.stages
            for b in g.buckets:
                if b.stages >= 1:
                    wb = _layout_warmup(b.stages, tg, b.mix_fs(g.out_rate))
                    ps.append((1 << g.stages) * wb + wg_washout)
        p = max(ps, default=0)
        return p if 0 < p <= self.block else 0

    def init_state(self) -> dict:
        """Fresh streaming state (nested dict of tensors on the device)."""
        dev = self.device
        plan = self.plan
        state: dict[str, Any] = {"dc": dc.dc_init_planar(dev)}
        if self.xtail_len():
            state["xtail"] = torch.zeros(2, self.xtail_len(), device=dev)
        for g in plan.groups:
            gs: dict[str, Any] = {}
            if not g.direct:
                gs["nco"] = nco.nco_init([g.mixer_freq], plan.fs, dev)
                gs["cascade"] = halfband.cascade_init_planar(1, g.stages, dev)
            for bi, b in enumerate(g.buckets):
                c = b.channels
                bs: dict[str, Any] = {
                    "nco": nco.nco_init(b.mixer_freqs(), b.mix_fs(g.out_rate), dev),
                    "usb": usbdemod.usb_init(c, dev),
                    "cascade": halfband.cascade_init_planar(c, b.stages, dev),
                }
                bk = f"g{g.index}/b{bi}"
                if f"{bk}/late" in self._c:
                    bs["late"] = fir.fir_history_init_planar(
                        c, self._c[f"{bk}/late"].shape[1], dev
                    )
                at = b.audio_taps()
                if at is not None:
                    bs["audio"] = stream.fir_history_init(c, at.shape[1], torch.float32, dev)
                gs[f"b{bi}"] = bs
            state[f"g{g.index}"] = gs
        return state

    def export_state(self, state: dict) -> dict[str, np.ndarray]:
        """State -> named host leaves in the canonical layout of the JAX
        package's ``CompiledReceiver.export_state``: complex64 for the DC
        mean, the tail and the cascade histories, uint32 for NCO integers,
        float32 otherwise."""
        out: dict[str, np.ndarray] = {}
        for key, v in flatten(state):
            # a copy: on the CPU .numpy() would share the state's memory,
            # which the next graph step rewrites in place
            a = v.detach().cpu().numpy().copy()
            if _is_planar_pair(key):
                out[key] = np.asarray(a[0] + 1j * a[1]).astype(np.complex64)
            elif a.dtype == np.int64:
                out[key] = a.astype(np.uint32)
            else:
                out[key] = a
        return out

    def import_state(self, named: dict) -> dict:
        """Named canonical leaves (from either package's ``export_state``)
        -> state on the device.  A tail of another length is left-padded
        with zeros or trimmed (a bounded warm-up transient, as in the JAX
        package); any other mismatch raises with the offending path."""
        conv = dict(named)
        want = self.xtail_len()
        if want and "xtail" not in conv:
            conv["xtail"] = np.zeros(want, np.complex64)
        elif want:
            h = np.asarray(conv["xtail"])
            if h.shape[-1] > want:
                conv["xtail"] = h[..., -want:]
            elif h.shape[-1] < want:
                conv["xtail"] = np.concatenate([np.zeros(want - h.shape[-1], h.dtype), h])

        def load(key: str, tmpl: torch.Tensor) -> torch.Tensor:
            if key not in conv:
                raise KeyError(f"checkpoint missing state entry {key!r}")
            h = np.asarray(conv[key])
            shape = tuple(tmpl.shape[1:] if _is_planar_pair(key) else tmpl.shape)
            if h.shape != shape:
                raise ValueError(
                    f"checkpoint entry {key!r} has shape {h.shape}, expected {shape}"
                )
            if _is_planar_pair(key):
                h = np.stack([h.real, h.imag]).astype(np.float32)
            else:
                h = h.astype(np.int64 if tmpl.dtype == torch.int64 else np.float32)
            return torch.tensor(h, device=self.device)

        def rebuild(tree, prefix: str = ""):
            if isinstance(tree, dict):
                return {k: rebuild(v, f"{prefix}{k}/") for k, v in tree.items()}
            if isinstance(tree, list):
                return [rebuild(v, f"{prefix}{i}/") for i, v in enumerate(tree)]
            return load(prefix[:-1], tree)

        return rebuild(self.init_state())

    # -------------------------------------------------------------- step
    def step_u8(self, state: dict, raw: torch.Tensor):
        """One block of interleaved u8 IQ ``[2T]`` (the dongle format)."""
        self._check_input(raw, torch.uint8, 2 * self.block)
        return self._step(state, raw)

    def step_f32(self, state: dict, raw: torch.Tensor):
        """One block of interleaved float32 IQ ``[2T]``."""
        self._check_input(raw, torch.float32, 2 * self.block)
        return self._step(state, raw)

    def step_iq(self, state: dict, iq: torch.Tensor):
        """One block of complex64 IQ ``[T]`` (its memory is the interleaved
        f32 layout, so it takes the f32 entry)."""
        self._check_input(iq, torch.complex64, self.block)
        return self._step(state, torch.view_as_real(iq.contiguous()).reshape(-1))

    def step_many_u8(self, state: dict, raws: torch.Tensor):
        """Burst entry: ``raws [k, 2T]`` uint8 -> k single steps, outputs
        stacked along a leading ``k`` axis (bit-equal to k calls of
        :meth:`step_u8`); one graph of k steps on the card."""
        self._check_input(raws, torch.uint8, 2 * self.block, burst=True)
        return self._step(state, raws)

    def step_many_f32(self, state: dict, raws: torch.Tensor):
        """Burst form of :meth:`step_f32` over ``raws [k, 2T]``."""
        self._check_input(raws, torch.float32, 2 * self.block, burst=True)
        return self._step(state, raws)

    def step_many_iq(self, state: dict, iqs: torch.Tensor):
        """Burst form of :meth:`step_iq` over ``iqs [k, T]``."""
        self._check_input(iqs, torch.complex64, self.block, burst=True)
        return self._step(state, torch.view_as_real(iqs.contiguous()).reshape(len(iqs), -1))

    def _step(self, state: dict, raw: torch.Tensor):
        """Interleaved u8 or f32 ``raw``, one block ``[2T]`` or a burst
        ``[k, 2T]``: the graph's replay on the card, else the eager step."""
        if self._graphs is not None:
            return self._graphs.step(state, raw)
        if raw.dim() == 2:
            return run_burst(self._step_raw, state, raw)
        return self._step_raw(state, raw)

    @staticmethod
    def unstack_outputs(outputs: dict, k: int) -> list[dict]:
        """Burst outputs -> k per-block output dicts (views along the
        leading axis), each in the form one step emits."""
        return [{key: v[i] for key, v in outputs.items()} for i in range(k)]

    def _tap(self, zr: torch.Tensor, zi: torch.Tensor) -> torch.Tensor:
        """Planar ``[2, T']`` tap: the last ``tap_samples`` samples (the
        scope FFTs the freshest window, mainwindow.cpp:418-427)."""
        lim = self.tap_samples
        if lim is not None and zr.shape[-1] > lim:
            zr, zi = zr[..., -lim:], zi[..., -lim:]
        return torch.stack([zr, zi])

    def _ingest(self, state: dict, raw: torch.Tensor):
        """Interleaved ``raw`` -> (new DC mean, the post-DC planar input as
        a list of time shards: one here)."""
        if self.plan.dc_correct:
            mean, x = self._run(self.dc_ingest, state["dc"], raw)
        elif raw.dtype == torch.uint8:
            mean, x = state["dc"], ingest.u8_iq_to_planar(raw)
        else:
            mean, x = state["dc"], ingest.f32_pairs_to_planar(raw)
        return mean, [x]

    def _input_tail(self, xs, n: int | None) -> torch.Tensor:
        """The last ``n`` samples (all for None) of the post-DC input as
        planar ``[2, n]``."""
        ((xr, xi),) = xs
        return torch.stack([xr[-n:], xi[-n:]]) if n else torch.stack([xr, xi])

    def _left_halos(self, state: dict, xs, p: int, phases: torch.Tensor):
        """Each shard's ``p`` warm-up inputs, planar ``[2, p]``, and the
        front's NCO ``phases`` on each shard's device: the carried xtail's
        last ``p`` and the phases themselves here."""
        return [state["xtail"][:, -p:]], [phases]

    def _gather_time(self, per_shard: dict) -> dict:
        """Per group index, per-shard planar ``[C, t]`` pairs -> ``{g<i>:
        (zr, zi)}`` over the whole block."""
        return {f"g{gi}": parts[0] for gi, parts in per_shard.items()}

    def _stateful_group(self, gs: dict, xs):
        """A group's mix + half-band cascade on its carried NCO phase and
        histories: (new NCO state, new histories, per-shard outputs)."""
        ((xr, xi),) = xs
        nco_state, z = nco.mix_block_planar(gs["nco"], (xr, xi), self.plan.fs)
        hists, z = halfband.cascade_apply_planar(gs["cascade"], z, self._hb1)
        return nco_state, hists, [z]

    def _step_raw(self, state: dict, raw: torch.Tensor):
        mean, xs = self._ingest(state, raw)
        new_state, zs = self._front(state, xs)
        new_state["dc"] = mean
        outputs: dict[str, torch.Tensor] = {}
        if "main" in self.emit_taps:
            outputs["tap/main"] = self._input_tail(xs, self.tap_samples)
        for g in self.plan.groups:
            gk = f"g{g.index}"
            zr, zi = zs[gk]
            if gk in self.emit_taps:
                outputs[f"tap/{gk}"] = self._tap(zr[0], zi[0])
            if g.publishes_iq:
                outputs[f"iq/{g.zmq_topic}"] = compress.compress_style1_planar(
                    (zr[0], zi[0]), self._iq_scale[g.index]
                )
            for bi in range(len(g.buckets)):
                new_state[gk][f"b{bi}"] = self._bucket_step(
                    g, bi, state[gk][f"b{bi}"], zs[gk], outputs, state
                )
        return new_state, outputs

    def _front(self, state: dict, xs):
        """Every group's full-rate mix + half-band cascade on ``xs``, the
        time shards of the post-DC planar input this process computes (one,
        the whole block, on one device).  Each kernel call is prefixed with
        the shard's ``p`` warm-up inputs (:meth:`_left_halos`), starts its
        NCO ``p`` samples early and drops the first ``p >> d`` outputs.
        Returns ``(partial new state with the new xtail, {g<i>: (zr, zi)
        [1, Tg]})``."""
        plan = self.plan
        fs = plan.fs
        t_local = self.block // self.n_time
        per_shard: dict[int, list] = {}
        for kerns, p, gidxs in self._fronts:
            phases = torch.cat([state[f"g{i}"]["nco"]["phase"] for i in gidxs])
            lefts, starts = self._left_halos(state, xs, p, phases)
            for (i, _), mc, ph, (xr, xi), (lr, li) in zip(self._shard_devices(), kerns, starts,
                                                          xs, lefts):
                # shard i's NCO starts i * t_local samples into the block
                if i:
                    ph = (ph + i * (mc.f_mod * t_local % fs) % fs) % fs
                yr, yi = self._run(
                    mc, phase_back(ph, mc.f_mod, fs, p),
                    torch.cat([lr, xr])[None], torch.cat([li, xi])[None],
                )
                for gi, d, zr, zi in zip(gidxs, mc.depths, mc.split(yr, t_local + p),
                                         mc.split(yi, t_local + p)):
                    per_shard.setdefault(gi, []).append((zr[p >> d:][None], zi[p >> d:][None]))
        new_state: dict[str, Any] = {}
        if self.xtail_len():
            new_state["xtail"] = xt = self._input_tail(xs, self.xtail_len())
        for g in plan.groups:
            gk = f"g{g.index}"
            gs = state.get(gk, {})
            ngs: dict[str, Any] = {}
            if g.direct:
                per_shard[g.index] = [(xr[None], xi[None]) for xr, xi in xs]
            elif g.index in per_shard:
                ngs["nco"] = dict(gs["nco"])
                ngs["nco"]["phase"] = nco.advance_per_block(gs["nco"], fs, self.block)
                # canonical cascade histories re-derived from the block's
                # mixed tail (exact by washout)
                w = warmup_len(g.stages)
                tst = dict(gs["nco"])
                tst["phase"] = nco.phase_minus(ngs["nco"], fs, w)
                _, ztail = nco.mix_block_planar(tst, (xt[0, -w:], xt[1, -w:]), fs)
                ngs["cascade"] = halfband.cascade_tails_from_tail(ztail, self._hb1, g.stages)
            else:
                # mix-only groups, every group at a block too short for the
                # kernels, and shards shorter than the warm-up: the stateful
                # path on the carried histories
                ngs["nco"], ngs["cascade"], per_shard[g.index] = self._stateful_group(gs, xs)
            new_state[gk] = ngs
        return new_state, self._gather_time(per_shard)

    def _prev_group_tail(self, state: dict, g, n_out: int):
        """Last ``n_out`` group-rate samples of the PREVIOUS block's group
        output, re-derived from the carried xtail: the warm-up prefix of
        this block's bucket kernels.  Direct groups: the raw tail.  Mix-only
        groups: the tail mixed at the rewound phase.  Cascaded groups: the
        last ``n_out * 2^stages + warmup`` inputs mixed at the rewound phase
        through a ZERO-state cascade, whose start washes out."""
        xt = state["xtail"]
        if g.direct:
            return xt[0, -n_out:][None], xt[1, -n_out:][None]
        fs = self.plan.fs
        gs = state[f"g{g.index}"]
        need = n_out if g.stages == 0 else n_out * (1 << g.stages) + warmup_len(g.stages)
        tst = dict(gs["nco"])
        tst["phase"] = nco.phase_minus(gs["nco"], fs, need)
        _, z = nco.mix_block_planar(tst, (xt[0, -need:], xt[1, -need:]), fs)
        if g.stages == 0:
            return z
        _, z = halfband.cascade_apply_planar(
            halfband.cascade_init_planar(1, g.stages, self.device), z, self._hb1
        )
        return z[0][:, -n_out:], z[1][:, -n_out:]

    def _bucket_step(self, g, bi: int, bs: dict, z, outputs: dict, state: dict) -> dict:
        """One sub-VFO bucket on the planar group baseband ``z`` ``[1, Tg]``:
        mix + cascade, per-channel scope taps, late /5 /6, USB demod, audio
        low-pass (direct or overlap-save FFT), int16 quantize."""
        b = g.buckets[bi]
        bk = f"g{g.index}/b{bi}"
        fs_b = b.mix_fs(g.out_rate)
        zr, zi = z
        nbs: dict[str, Any] = {}
        if bk in self._bucket_mc:
            w = warmup_len(b.stages)
            ptr, pti = self._prev_group_tail(state, g, w)
            yr, yi = self._run(
                self._bucket_mc[bk],
                nco.phase_minus(bs["nco"], fs_b, w),
                torch.cat([ptr, zr], dim=-1),
                torch.cat([pti, zi], dim=-1),
            )
            drop = w >> b.stages
            y = (
                yr.view(b.channels, -1)[:, drop:],
                yi.view(b.channels, -1)[:, drop:],
            )
            nbs["nco"] = dict(bs["nco"])
            nbs["nco"]["phase"] = nco.advance_per_block(bs["nco"], fs_b, zr.shape[-1])
            tst = dict(bs["nco"])
            tst["phase"] = nco.phase_minus(nbs["nco"], fs_b, w)
            _, ztail = nco.mix_block_planar(tst, (zr[0, -w:], zi[0, -w:]), fs_b)
            nbs["cascade"] = halfband.cascade_tails_from_tail(
                ztail, self._c[f"{bk}/hb"], b.stages
            )
        else:
            nbs["nco"], y = nco.mix_block_planar(bs["nco"], (zr[0], zi[0]), fs_b)
            nbs["cascade"], y = halfband.cascade_apply_planar(
                bs["cascade"], y, self._c[f"{bk}/hb"]
            )
        for ci, s in enumerate(b.subs):
            # the decimated pre-demod baseband, where the reference's
            # per-VFO scope taps it (vfo.cpp:290-295, before the late stage)
            if s.topic in self.emit_taps:
                outputs[f"tap/{s.topic}"] = self._tap(y[0][ci], y[1][ci])
        if f"{bk}/late" in self._c:
            nbs["late"], y = polyphase.late_decim_apply(
                bs["late"], y, self._c[f"{bk}/late"], b.late_factor
            )
        nbs["usb"], audio = usbdemod.usb_block_planar(bs["usb"], y, self._c[f"{bk}/hilbert"])
        if bk in self._oss:
            nbs["audio"], audio = ossfft.oss_block(bs["audio"], audio, self._oss[bk])
        elif f"{bk}/audio" in self._c:
            nbs["audio"], audio = fir.conv_block(bs["audio"], audio, self._c[f"{bk}/audio"])
        outputs[f"pcm/{bk}"] = usbdemod.quantize_i16(audio, self._c[f"{bk}/gains"]).reshape(-1)
        return nbs

    # ----------------------------------------------------------- outputs
    def split_audio(self, outputs: dict) -> dict:
        """Packed ``pcm/g<i>/b<j>`` buffers -> per-channel ``audio/<topic>``
        views (tensors or host arrays alike)."""
        out = {k: v for k, v in outputs.items() if not k.startswith("pcm/")}
        for g in self.plan.groups:
            tg = self.block >> g.stages
            for bi, b in enumerate(g.buckets):
                flat = outputs.get(f"pcm/g{g.index}/b{bi}")
                if flat is None:
                    continue
                ta = (tg >> b.stages) // b.late_factor
                for ci, s in enumerate(b.subs):
                    out[f"audio/{s.topic}"] = flat[ci * ta : (ci + 1) * ta]
        return out

    def tap_rates(self) -> dict[str, int]:
        """Valid scope tap name -> its sample rate: "main" (input rate),
        "g<i>" (group output rate), or a sub-VFO topic (its pre-late rate).
        Raises ``ValueError`` for a topic used twice (the two channels'
        outputs would shadow each other) or a topic named like a built-in
        tap ("main", "g<i>")."""
        r: dict[str, int] = {"main": self.plan.fs}
        for g in self.plan.groups:
            r[f"g{g.index}"] = g.out_rate
        seen: set[str] = set()
        for g in self.plan.groups:
            for b in g.buckets:
                for s in b.subs:
                    if s.topic in seen:
                        raise ValueError(
                            f"duplicate sub-VFO topic {s.topic!r}: each "
                            f"channel needs a unique topic — its "
                            f"audio/{s.topic} output (and scope tap) would "
                            f"shadow the other channel's"
                        )
                    if s.topic in r:
                        raise ValueError(
                            f"scope tap name collision: sub-VFO topic "
                            f"{s.topic!r} clashes with the built-in "
                            f"{s.topic!r} tap (reserved names: 'main', "
                            f"'g<i>')"
                        )
                    seen.add(s.topic)
                    r[s.topic] = b.out_rate * b.late_factor
        return r

    def rates(self) -> dict[str, int]:
        """Output key -> sample rate (the ZMQ wire rate field)."""
        r: dict[str, int] = {}
        for g in self.plan.groups:
            if g.publishes_iq:
                r[f"iq/{g.zmq_topic}"] = g.out_rate
            for b in g.buckets:
                for s in b.subs:
                    r[f"audio/{s.topic}"] = b.out_rate
        return r

    def output_shapes(self) -> dict[str, tuple[int, ...]]:
        """Public (post-:meth:`split_audio`) output key -> shape."""
        shapes: dict[str, tuple[int, ...]] = {}
        for g in self.plan.groups:
            tg = self.block >> g.stages
            if g.publishes_iq:
                shapes[f"iq/{g.zmq_topic}"] = (tg,)
            for b in g.buckets:
                ta = (tg >> b.stages) // b.late_factor
                for s in b.subs:
                    shapes[f"audio/{s.topic}"] = (ta,)
        return shapes
