"""Fused IQ ingest + DC-EMA removal: the ``csrc/dc_ingest.cu`` wrapper.

Counterpart of ``sdrreceiver_tpu/pallas/dckernel.py`` (both of its
instances: the u8 entry with ``v - 127`` fused into the load, and the f32
entry).  The kernel reads the interleaved stream directly, once, in one
launch (a chained scan with decoupled look-back over tiles of
:data:`TILE` samples).  Its plain version is :func:`dc_ingest_plain`:
``kernels.ingest`` then the closed-form ``kernels.dc.dc_block_planar``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..kernels import dc, ingest
from . import build

__all__ = ["DcIngest", "dc_ingest_plain", "decay_table", "TILE", "LOOK"]

TILE = 4096  # samples per kernel tile (dc_ingest.cu kTile); the last may be partial
LOOK = 128  # predecessors a tile sums (dc_ingest.cu kLook)


@functools.cache
def decay_table(alpha: float) -> np.ndarray:
    """The kernel's decay powers as float32, each ``exp(n log1p(-alpha))``
    in float64 rounded once (``kernels.dc.decay_pow``): ``a^n`` for ``n =
    0..TILE``, then ``a^(TILE j)`` for ``j = 0..LOOK``."""
    n = np.concatenate([np.arange(TILE + 1), TILE * np.arange(LOOK + 1)])
    return dc.decay_pow(alpha, n).astype(np.float32)


def dc_ingest_plain(
    mean: torch.Tensor, raw: torch.Tensor
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """``mean [2]`` f32 and interleaved ``raw [2T]`` (uint8 or float32) ->
    ``(new_mean [2], (yr [T], yi [T]))``."""
    if raw.dtype == torch.uint8:
        x = ingest.u8_iq_to_planar(raw)
    else:
        x = ingest.f32_pairs_to_planar(raw)
    return dc.dc_block_planar(mean, x)


class DcIngest(torch.nn.Module):
    """``(mean [2] f32, raw [2T] u8 or f32) -> (new_mean [2], (yr, yi))``.

    CPU tensors take :func:`dc_ingest_plain`.  CUDA tensors launch the
    kernel (any T >= 1; ``raw`` contiguous and 16-byte aligned) or raise.
    ``launches`` counts kernel launches."""

    def __init__(self):
        super().__init__()
        self._pw: dict[torch.device, torch.Tensor] = {}  # decay_table per device
        self.launches = 0

    def plain(self, mean: torch.Tensor, raw: torch.Tensor):
        return dc_ingest_plain(mean, raw)

    def forward(self, mean: torch.Tensor, raw: torch.Tensor):
        if raw.device.type == "cpu":
            return self.plain(mean, raw)
        if raw.device.type != "cuda":
            raise ValueError(f"DcIngest: unsupported device {raw.device}")
        if raw.dtype not in (torch.uint8, torch.float32):
            raise TypeError(f"DcIngest: raw must be uint8 or float32, got {raw.dtype}")
        if raw.dim() != 1 or raw.numel() < 2 or raw.numel() % 2:
            raise ValueError(f"DcIngest: raw must be interleaved [2T], got {tuple(raw.shape)}")
        if not raw.is_contiguous() or raw.data_ptr() % 16:
            raise ValueError("DcIngest: raw must be contiguous and 16-byte aligned")
        if (
            mean.device != raw.device
            or mean.dtype != torch.float32
            or mean.shape != (2,)
            or not mean.is_contiguous()
        ):
            raise ValueError("DcIngest: mean must be a contiguous float32 [2] on raw's device")
        t_len = raw.numel() // 2
        dev = raw.device
        yr = torch.empty(t_len, dtype=torch.float32, device=dev)
        yi = torch.empty(t_len, dtype=torch.float32, device=dev)
        new_mean = torch.empty(2, dtype=torch.float32, device=dev)
        # the ticket, then per tile two published (re, im) word pairs;
        # cleared on the stream by the launch entry
        scratch = torch.empty(1 + 4 * -(-t_len // TILE), dtype=torch.int64, device=dev)
        pw = self._pw.get(dev)
        if pw is None:
            pw = self._pw[dev] = torch.tensor(decay_table(dc.DEFAULT_ALPHA), device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = build.library().dc_ingest_launch(
                raw.data_ptr(), int(raw.dtype == torch.uint8), t_len,
                mean.data_ptr(), new_mean.data_ptr(), yr.data_ptr(),
                yi.data_ptr(), scratch.data_ptr(), pw.data_ptr(), dc.DEFAULT_ALPHA,
                stream,
            )
        build.check(err, "dc_ingest_launch")
        self.launches += 1
        return new_mean, (yr, yi)
