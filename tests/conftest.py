"""Test configuration: run every test on the CPU with 8 virtual devices.

The suite runs on the CPU even on a machine with a GPU, so that parallel
test workers never open the card (each JAX process on a GPU reserves most
of its memory).  Multi-device sharding is checked on the 8 virtual CPU
devices; ``python chip_smoke.py`` is the run on the GPU.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1951)
