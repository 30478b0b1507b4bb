"""8-bit IQ compression for forwarding main-VFO baseband (vfo.cpp:389-424).

Port of ``sdrreceiver_tpu.kernels.compress``.  Two wire styles:

  style 1 ("packed nibbles"): each complex sample becomes ONE byte, the top
    4 bits of int8(re/scale*128) and of int8(im/scale*128) packed as
    (re & 0xF0) | ((im & 0xF0) >> 4)                        (vfo.cpp:397-405)
  style 2 ("interleaved i8"): int8(re*128), int8(im*128)    (vfo.cpp:413-420)

The reference's float->signed-char casts truncate toward zero; values are
truncated toward zero and saturated to [-128, 127], then packed in int32 as
C promotes them.  Bit-exact with the JAX package on the same float input:
the scale divides as a float32 tensor (a Python scalar divisor may become a
multiply by its reciprocal on CUDA).  A caller that steps repeatedly builds
that tensor once (:func:`scale_tensor`), so no step uploads it.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["scale_tensor", "compress_style1", "compress_style1_planar", "compress_style2"]


def _to_i8_trunc(v: torch.Tensor) -> torch.Tensor:
    """float -> int32 in [-128, 127] with C cast semantics (truncate toward
    zero), saturated."""
    return torch.clamp(torch.trunc(v), -128.0, 127.0).to(torch.int32)


def scale_tensor(scale: float, device: torch.device | str) -> torch.Tensor:
    """The divisor of :func:`compress_style1_planar`: float32 0-d on ``device``."""
    return torch.tensor(np.float32(scale), device=device)


def _scaled(v: torch.Tensor, scale: float | torch.Tensor) -> torch.Tensor:
    s = scale if isinstance(scale, torch.Tensor) else scale_tensor(scale, v.device)
    return v / s * 128.0


def compress_style1_planar(
    x: tuple[torch.Tensor, torch.Tensor], scale: float | torch.Tensor = 1.0
) -> torch.Tensor:
    """Planar ``x = (re, im)`` f32 ``[.., T]`` -> ``[.., T]`` uint8;
    ``scale`` a number or a :func:`scale_tensor` on ``x``'s device."""
    re = _to_i8_trunc(_scaled(x[0], scale))
    im = _to_i8_trunc(_scaled(x[1], scale))
    return ((re & 0xF0) | ((im & 0xF0) >> 4)).to(torch.uint8)


def compress_style1(x: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """Complex ``[.., T]`` -> ``[.., T]`` uint8 packed-nibble stream."""
    return compress_style1_planar((x.real, x.imag), scale)


def compress_style2(x: torch.Tensor) -> torch.Tensor:
    """Complex ``[.., T]`` -> ``[.., 2T]`` int8 interleaved I/Q stream."""
    re = _to_i8_trunc(x.real * 128.0).to(torch.int8)
    im = _to_i8_trunc(x.imag * 128.0).to(torch.int8)
    return torch.stack([re, im], dim=-1).reshape(*x.shape[:-1], -1)
