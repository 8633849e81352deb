"""Test harness configuration.

Forces the CPU backend with 8 virtual devices so multi-chip sharding
(mesh/shard_map/psum paths) is unit-testable on one machine, per
SURVEY.md §4 ("Multi-host without a cluster"), and enables x64 so the EM
can run in float64 and match the C++ reference's double math bit-for-bit.

Must set env vars before jax is imported anywhere.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_ENABLE_X64"] = "1"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

# Pin the CPU backend in JAX's config too, before any backend is
# initialized, so the tests run on the 8-device virtual CPU mesh even if
# something imported JAX before JAX_PLATFORMS was set above.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
# CLI code paths enable the persistent compilation cache; keep tests
# hermetic (and immune to cross-run stale-executable issues) by
# disabling it for the whole test process.
jax.config.update("jax_enable_compilation_cache", False)

import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0xC0FFEE)
