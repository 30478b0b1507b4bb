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
    dev = x.device
    xb = torch.nn.functional.pad(x, (0, pad)).reshape(*lead, nb, b)
    w = torch.as_tensor(_prefix_matrix(alpha, b), device=dev)
    with no_tf32():
        v = xb @ w  # v[k, j] = alpha * sum_{i<=j} a^(j-i) x[k, i]
    # across rows: P[k] = sum_{t<=k} a^(B(k-t)) bk[t] = a^(Bk) cumsum(bk a^(-Bt))
    kb = torch.arange(nb, device=dev)
    p = torch.cumsum(v[..., -1] * _decay(alpha, -b * kb), dim=-1) * _decay(
        alpha, b * kb
    )
    # carry into row k is m_end(k-1); it decays as a^(j+1) inside row k
    e = torch.cat([torch.zeros_like(p[..., :1]), p[..., :-1]], dim=-1)
    a_j1 = _decay(alpha, torch.arange(1, b + 1, device=dev))
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
    a_n1 = _decay(alpha, torch.arange(1, t_len + 1, device=x2.device))
    m = a_n1[None, :] * mean[:, None] + v
    y = x2 - m
    return m[:, -1].contiguous(), (y[0], y[1])
