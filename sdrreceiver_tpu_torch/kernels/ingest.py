"""Front-end sample conversion: interleaved IQ -> planar float32 planes.

Port of ``sdrreceiver_tpu.kernels.ingest``.  Reference: a 256-entry lookup
table ``(i - 127) * 1.0`` applied on the USB callback thread
(jonti/sdr.cpp:43-49) and the float-pair -> complex packing of
sdrj::demodData (sdrj.cpp:266-286).  The JAX package's ``[T/256, 256]`` row
forms are a TPU layout device and are not ported.
"""

from __future__ import annotations

import torch

__all__ = ["u8_iq_to_planar", "f32_pairs_to_planar"]


def u8_iq_to_planar(raw: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``[2T] uint8`` interleaved I,Q -> planar ``([T] f32, [T] f32)``,
    value (v - 127) — the reference LUT scale exactly (scale 1.0, offset 127,
    not the textbook 127.5)."""
    return f32_pairs_to_planar(raw.to(torch.float32) - 127.0)


def f32_pairs_to_planar(raw: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``[2T] float32`` interleaved I,Q -> contiguous planar pair."""
    pairs = raw.reshape(-1, 2)
    return pairs[:, 0].contiguous(), pairs[:, 1].contiguous()
