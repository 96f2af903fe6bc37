"""Test configuration.

Forces JAX onto a virtual 8-device CPU mesh so multi-chip sharding logic is
exercised without a GPU (the real-card path is covered by chip_smoke.py and
bench.py, run on the GPU host).
"""

import os

# Must be set before jax initializes. Force (not setdefault): a GPU host's
# environment may name another platform, but tests run on the virtual
# 8-device CPU mesh.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import random  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

# jax may already be imported (and its platform baked into jax.config)
# before this conftest runs — override via config too.
try:  # noqa: SIM105
    import jax  # noqa: E402

    jax.config.update("jax_platforms", "cpu")
except Exception:  # noqa: BLE001
    pass


@pytest.fixture(scope="session")
def corpus():
    from tests.corpus import make_corpus
    return make_corpus()


@pytest.fixture()
def rng():
    return random.Random(1234)
