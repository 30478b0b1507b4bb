"""The one traffic generator: repeatable per seed, and the recording it makes."""

import json

import numpy as np

from benchpaths import HERE
from harness import gen

CFG = json.loads((HERE / "configs" / "flagship_25e.json").read_text())


def test_same_seed_same_recording():
    a = gen.recording(CFG, 3840, 3, 2**31 + 11, "cpu")
    b = gen.recording(CFG, 3840, 3, 2**31 + 11, "cpu")
    assert a.dtype == np.uint8 and a.shape == (3, 2 * 3840)
    assert np.array_equal(a, b)


def test_other_seed_other_recording():
    a = gen.recording(CFG, 3840, 2, 5, "cpu")
    b = gen.recording(CFG, 3840, 2, 6, "cpu")
    assert np.mean(a != b) > 0.5


def test_level_and_tones():
    """Noise of 1.0 and tones of 4 around the dongle's 127: the values the
    signal entry asks for, nothing clipped."""
    a = gen.recording(CFG, 38400, 1, 1, "cpu")[0].astype(np.float64) - 127.0
    n_tones = len(gen.tones(CFG))
    assert n_tones == 9
    # power: 2 x noise^2 + n_tones x amplitude^2 (+ 2/12 of rounding)
    want = 2 * 1.0 + n_tones * 16.0 + 2 / 12
    assert abs(np.mean(a[0::2] ** 2 + a[1::2] ** 2) / want - 1) < 0.05
    assert 0 < a.min() + 127 and a.max() + 127 < 255
