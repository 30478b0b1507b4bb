"""The table of peaks and the least time the two hand-written kernels need
per step at a cell's shapes (copied from the program's
``cuda/devtime.py``: ``dc_bound``, ``mc_bound``).

A kernel's bound is the larger of its bytes over the card's memory
bandwidth and its float64 operations over the FP64 peak, with each input
read once and each output written once.  The work counted is what the
plan needs at the block, whatever implements it: the fused ingest + DC
reads the u8 block and writes two float32 planes; the mix + cascade sites
(every group with a /2 cascade over one shared read of the post-DC block,
and every channel bucket with a cascade over one read of its group's
output) mix each channel and run its cascade as one composite FIR of
``10 (2^d - 1) + 1`` taps at the output rate.  A warm-up prefix the
program reads to stay stateless is not counted.
"""

from __future__ import annotations

from reference.receiver import mains, plan

__all__ = ["PEAKS", "dc_ingest_bound_us", "mix_cascade_bound_us"]

#: NVIDIA H100 SXM data sheet, dense: HBM3 bandwidth and the FP64
#: tensor-core rate, at the 700 W power limit.
PEAKS = {"hbm_bytes_per_s": 3.35e12, "fp64_flops": 67e12}


def _bound_us(moved: float, flops: float) -> float:
    return 1e6 * max(moved / PEAKS["hbm_bytes_per_s"], flops / PEAKS["fp64_flops"])


def dc_ingest_bound_us(cfg: dict, block: int) -> float | None:
    """u8 ``[2T]`` in, two float32 planes out; None without DC removal."""
    _, dc, _ = plan(cfg)
    return _bound_us(2 * block + 8 * block, 0.0) if dc else None


def _mc(t_in: int, depths: list[int]) -> tuple[float, float]:
    moved = 8 * t_in + sum(8 * (t_in >> d) for d in depths)
    flops = sum(6 * t_in + 4 * (10 * ((1 << d) - 1) + 1) * (t_in >> d) for d in depths)
    return moved, flops


def mix_cascade_bound_us(cfg: dict, block: int) -> float | None:
    """The sum over the plan's mix + cascade sites; None if it has none."""
    _, _, chains = plan(cfg)
    stages = [m[3] for m in mains(cfg)]
    sites = []
    front = [d for d in stages if d >= 1]
    if front:
        sites.append(_mc(block, front))
    buckets: dict[tuple, list[int]] = {}
    for c in chains:
        if c.stages >= 1:
            buckets.setdefault((c.group, c.stages, c.late, c.out_rate), []).append(c.stages)
    for (g, _, _, _), depths in buckets.items():
        t_in = block >> (stages[g] if g is not None else 0)
        sites.append(_mc(t_in, depths))
    if not sites:
        return None
    return _bound_us(sum(m for m, _ in sites), sum(f for _, f in sites))
