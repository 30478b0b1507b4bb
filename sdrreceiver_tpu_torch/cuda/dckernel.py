"""Fused IQ ingest + DC-EMA removal: the ``csrc/dc_ingest.cu`` wrapper.

Counterpart of ``sdrreceiver_tpu/pallas/dckernel.py`` (both of its
instances: the u8 entry with ``v - 127`` fused into the load, and the f32
entry).  The kernel reads the interleaved stream directly.  Its plain
version is :func:`dc_ingest_plain`: ``kernels.ingest`` then the closed-form
``kernels.dc.dc_block_planar``.
"""

from __future__ import annotations

import torch

from ..kernels import dc, ingest
from . import build

__all__ = ["DcIngest", "dc_ingest_plain"]


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
        # one (re, im) pair per tile of at least 256 samples
        scratch = torch.empty(2, -(-t_len // 256), 2, dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = build.library().dc_ingest_launch(
                raw.data_ptr(), int(raw.dtype == torch.uint8), t_len,
                mean.data_ptr(), new_mean.data_ptr(), yr.data_ptr(),
                yi.data_ptr(), scratch[0].data_ptr(), scratch[1].data_ptr(),
                dc.DEFAULT_ALPHA, stream,
            )
        build.check(err, "dc_ingest_launch")
        self.launches += 1
        return new_mean, (yr, yi)
