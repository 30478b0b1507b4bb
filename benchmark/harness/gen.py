"""The one traffic generator: a seeded u8 dongle recording of a configuration.

The signal is the configuration's ``signal`` entry: a USB tone of
``tone_amplitude`` at the carrier of every ``tone_every``-th channel (tone
``tone_hz + tone_step_hz * i`` Hz for the channel at position ``i``), with a
phase drawn from the seed, plus complex Gaussian noise of ``noise`` per
component, quantised as a dongle does (``round(v + 127)`` clipped to
0..255, I and Q interleaved).  Everything is made on ``device`` from one
``torch.Generator`` in a few large calls, then copied to host memory, which
stands for a recording read from disk.  Tone phases are exact: the phase
of sample ``n`` is the integer ``(f n) mod fs``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["tones", "recording"]


def tones(cfg: dict) -> dict[str, float]:
    """topic -> audio tone Hz of the channels that carry one."""
    sig = cfg["signal"]
    return {v["topic"]: sig["tone_hz"] + sig["tone_step_hz"] * i
            for i, v in enumerate(cfg["vfos"]) if i % sig["tone_every"] == 0}


def recording(cfg: dict, block: int, n_blocks: int, seed: int,
              device: str | torch.device) -> np.ndarray:
    """u8 ``[n_blocks, 2 * block]``: the same array for the same seed."""
    fs, center = int(cfg["sample_rate"]), int(cfg["center_frequency"])
    sig = cfg["signal"]
    n_len = n_blocks * block
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % 2**63)
    x = torch.randn(2, n_len, generator=g, device=device) * float(sig["noise"])
    want = tones(cfg)
    phase0 = torch.rand(len(want), generator=g, device=device, dtype=torch.float64)
    n = torch.arange(n_len, device=device, dtype=torch.int64)
    acc = torch.zeros(2, n_len, device=device, dtype=torch.float64)
    by_topic = {v["topic"]: v for v in cfg["vfos"]}
    for k, (topic, tone) in enumerate(want.items()):
        f = (int(by_topic[topic]["frequency"]) - center + int(tone)) % fs
        theta = (f * n % fs).to(torch.float64) * (2.0 * math.pi / fs) + 2.0 * math.pi * phase0[k]
        acc[0] += torch.cos(theta)
        acc[1] += torch.sin(theta)
    x += (acc * float(sig["tone_amplitude"])).to(torch.float32)
    u8 = torch.clamp(torch.round(x.t() + 127.0), 0, 255).to(torch.uint8)
    return u8.reshape(n_blocks, 2 * block).cpu().numpy()
