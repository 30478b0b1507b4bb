"""The check that a run loaded no JAX compares whole top-level names."""

import benchpaths  # noqa: F401  (the benchmark's folder on sys.path)
from harness import nojax


def test_rejects_jax_and_the_jax_package():
    mods = ["numpy", "jax.numpy", "jaxlib", "flax.linen", "sdrreceiver_tpu.graph.compiler"]
    assert nojax.loaded(mods) == ["flax", "jax", "jaxlib", "sdrreceiver_tpu"]


def test_accepts_the_port():
    mods = ["sdrreceiver_tpu_torch", "sdrreceiver_tpu_torch.graph.compiler", "jaxtyping_like",
            "jaxfoo", "sdrreceiver_tpu_extra"]
    assert nojax.loaded(mods) == []
