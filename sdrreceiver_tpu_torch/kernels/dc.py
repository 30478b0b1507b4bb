"""DC-bias removal: one-pole EMA high-pass, evaluated block-parallel.

Port of ``sdrreceiver_tpu.kernels.dc``, the plain version of the fused
ingest+DC kernel (``cuda/dckernel.py``).  The reference runs, per complex
sample (sdrj.cpp:277-283):

    avept = avept*(1 - 1e-6) + 1e-6*curr ;  curr -= avept

The closed form of ``m[n] = a*m[n-1] + alpha*x[n]`` (a = 1 - alpha) is

    m[n] = a^(n+1)*m0 + alpha * sum_{i<=n} a^(n-i) x[i]

evaluated as in the JAX package: a [256, 256] triangular matrix product for
the prefix inside each 256-sample row, a cumulative sum across rows, and the
decay of the carried mean.  Every power of ``a`` is taken in float64 and
rounded once to float32: ``a`` itself in float32 is 1 - 1e-6 to within 3%
of ``alpha``, which over a 1.5 Msample block would misplace the mean by
several percent.

The constants of a block size (the prefix matrix, the row decays, the
carry ramp) are built once per (device, size) and kept, read-only
(:func:`decay_ramp`, :func:`decay_scalar`), so a step makes no host
upload and a CUDA graph can hold it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .fir import no_tf32

__all__ = [
    "DEFAULT_ALPHA",
    "decay_pow",
    "dc_init_planar",
    "decay_ramp",
    "decay_scalar",
    "zero_prefix",
    "dc_block_planar",
]

#: The reference's EMA coefficient (sdrj.cpp:11 ``val = 0.000001``).
DEFAULT_ALPHA = 1e-6

_BLOCK = 256


def decay_pow(alpha: float, n) -> np.ndarray | float:
    """a^n in float64 on the host (a = 1-alpha)."""
    return np.exp(np.multiply(n, np.log1p(-alpha), dtype=np.float64))


def _decay(alpha: float, n: torch.Tensor) -> torch.Tensor:
    """a^n for an integer tensor ``n``, in float64 rounded to float32 — the
    device-side twin of ``decay_pow(...).astype(float32)``."""
    return torch.exp(n.to(torch.float64) * np.log1p(-alpha)).to(torch.float32)


@functools.lru_cache(maxsize=8)
def _prefix_matrix(alpha: float, b: int) -> np.ndarray:
    """``W[i, j] = alpha * a^(j-i)`` for ``i <= j`` else 0: the weighted
    within-row prefix as one [B, B] triangular matrix."""
    i = np.arange(b, dtype=np.float64)
    w = alpha * decay_pow(alpha, i[None, :] - i[:, None])
    return np.triu(w).astype(np.float32)


@functools.lru_cache(maxsize=64)
def decay_ramp(alpha: float, n: int, device: torch.device) -> torch.Tensor:
    """``a^1 .. a^n`` as float32 ``[n]`` on ``device`` (built once per
    device and length)."""
    return _decay(alpha, torch.arange(1, n + 1, device=device))


@functools.lru_cache(maxsize=64)
def decay_scalar(alpha: float, n: int, device: torch.device) -> torch.Tensor:
    """``a^n`` as a float32 scalar tensor on ``device``, rounded from float64
    on the host (built once per device and ``n``)."""
    return torch.tensor(np.float32(decay_pow(alpha, float(n))), device=device)


@functools.lru_cache(maxsize=64)
def _prefix_consts(alpha: float, b: int, nb: int, device: torch.device):
    """:func:`zero_prefix`'s constants for ``nb`` rows of ``b`` on
    ``device``: the prefix matrix, ``a^(-Bk)``, ``a^(Bk)`` and ``a^(j+1)``."""
    kb = torch.arange(nb, device=device)
    return (torch.as_tensor(_prefix_matrix(alpha, b), device=device),
            _decay(alpha, -b * kb), _decay(alpha, b * kb), decay_ramp(alpha, b, device))


def dc_init_planar(device: torch.device | str) -> torch.Tensor:
    """Zero initial mean as planar ``[2]`` f32 (re, im)."""
    return torch.zeros(2, dtype=torch.float32, device=device)


def zero_prefix(x: torch.Tensor, alpha: float = DEFAULT_ALPHA) -> torch.Tensor:
    """``m`` for the whole ``[..., T]`` block assuming zero initial mean."""
    t_len = x.shape[-1]
    b = min(_BLOCK, t_len)
    nb = -(-t_len // b)
    pad = nb * b - t_len
    lead = x.shape[:-1]
    xb = torch.nn.functional.pad(x, (0, pad)).reshape(*lead, nb, b)
    w, a_neg, a_pos, a_j1 = _prefix_consts(alpha, b, nb, x.device)
    with no_tf32():
        v = xb @ w  # v[k, j] = alpha * sum_{i<=j} a^(j-i) x[k, i]
    # across rows: P[k] = sum_{t<=k} a^(B(k-t)) bk[t] = a^(Bk) cumsum(bk a^(-Bt))
    p = torch.cumsum(v[..., -1] * a_neg, dim=-1) * a_pos
    # carry into row k is m_end(k-1); it decays as a^(j+1) inside row k
    e = torch.cat([torch.zeros_like(p[..., :1]), p[..., :-1]], dim=-1)
    m = a_j1 * e[..., None] + v
    return m.reshape(*lead, nb * b)[..., :t_len]


def dc_block_planar(
    mean: torch.Tensor,
    x: tuple[torch.Tensor, torch.Tensor],
    alpha: float = DEFAULT_ALPHA,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Remove DC from a planar block: ``mean [2]`` f32, ``x = (re, im)``
    each ``[T]`` f32.  Returns ``(new_mean [2], (yr, yi))`` with the EMA
    mean threaded across block boundaries."""
    x2 = torch.stack(x)
    t_len = x2.shape[-1]
    v = zero_prefix(x2, alpha)
    m = decay_ramp(alpha, t_len, x2.device)[None, :] * mean[:, None] + v
    y = x2 - m
    return m[:, -1].contiguous(), (y[0], y[1])
