"""Exact integer-phase NCO mixers (port of ``sdrreceiver_tpu.kernels.nco``).

Phase is carried as an exact integer numerator of cycles,

    theta[n] = 2*pi * ((phase0 + f*n) mod Fs) / Fs

(every mixer frequency in the config system is an integer Hz:
mainwindow.cpp:131,220), so it never drifts.  The JAX package does this
modular arithmetic in uint32 with a two-level split to keep products below
2^32; here every integer is int64 (torch's uint32 supports few ops), where
``f*n`` stays below 2^63 for any block a receiver would use.  The integers
equal the JAX package's uint32 values exactly; the state is exported as
uint32 (``graph/compiler.py``).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "nco_init",
    "block_step_mod",
    "advance_per_block",
    "phase_minus",
    "theta_planar",
    "phasor_planar",
    "mix_block_planar",
]

_K = 2048  # the JAX package's split width; kept for its ``fK`` state leaf


def nco_init(freqs_hz, fs: int, device: torch.device | str) -> dict:
    """NCO constants + zero-phase state: ``phase`` (carried), ``f`` (f mod
    fs) and ``fK`` (f*2048 mod fs, the JAX state layout), int64 ``[C]``.

    ``freqs_hz`` are integer mixer frequencies (either sign: the
    reference's mixer freq is center - channel)."""
    f = np.atleast_1d(np.asarray(freqs_hz))
    if not np.issubdtype(f.dtype, np.integer):
        fi = np.round(f).astype(np.int64)
        if not np.allclose(f, fi):
            raise ValueError("NCO frequencies must be integer Hz")
        f = fi
    f = np.mod(f.astype(np.int64), fs)
    return {
        "phase": torch.zeros(f.shape, dtype=torch.int64, device=device),
        "f": torch.tensor(f, dtype=torch.int64, device=device),
        "fK": torch.tensor(f * _K % fs, dtype=torch.int64, device=device),
    }


def block_step_mod(state: dict, fs: int, t_len: int) -> torch.Tensor:
    """``(f * t_len) mod fs`` per channel, exactly."""
    return state["f"] * t_len % fs


def advance_per_block(state: dict, fs: int, t_len: int) -> torch.Tensor:
    """New phase after ``t_len`` samples: ``(phase + f*t_len) mod fs``."""
    return (state["phase"] + block_step_mod(state, fs, t_len)) % fs


def phase_minus(state: dict, fs: int, n: int) -> torch.Tensor:
    """Phase ``n`` samples BEFORE the carried phase: what a warm-up-prefixed
    kernel or a derived-tail mix starts from."""
    return (state["phase"] + fs - block_step_mod(state, fs, n)) % fs


def theta_planar(
    phase: torch.Tensor, f: torch.Tensor, fs: int, t_len: int
) -> torch.Tensor:
    """The exact per-channel phase ramp as angles, ``[C, T]`` f32:
    ``theta = f32((phase + f*n mod fs) mod fs) * f32(2 pi / fs)``."""
    n = torch.arange(t_len, dtype=torch.int64, device=phase.device)
    m = (phase[:, None] + f[:, None] * n % fs) % fs
    return m.to(torch.float32) * float(np.float32(2.0 * np.pi / fs))


def phasor_planar(
    phase: torch.Tensor, f: torch.Tensor, fs: int, t_len: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) of :func:`theta_planar`, ``[C, T]`` f32."""
    theta = theta_planar(phase, f, fs, t_len)
    return torch.cos(theta), torch.sin(theta)


def mix_block_planar(
    state: dict,
    x: tuple[torch.Tensor, torch.Tensor],
    fs: int,
) -> tuple[dict, tuple[torch.Tensor, torch.Tensor]]:
    """Mix a planar block by per-channel phasors, ``y[c, n] = x[.., n] *
    e^{j theta_c[n]}``.  ``x = (re, im)``, each ``[T]`` (one stream fanned
    out to C channels, vfo.cpp:237-245) or ``[C, T]``; returns the new state
    and the mixed planar pair ``[C, T]``."""
    xr, xi = x
    t_len = xr.shape[-1]
    c, s = phasor_planar(state["phase"], state["f"], fs, t_len)
    if xr.dim() == 1:
        xr, xi = xr[None, :], xi[None, :]
    new_state = dict(state)
    new_state["phase"] = advance_per_block(state, fs, t_len)
    return new_state, (xr * c - xi * s, xr * s + xi * c)
