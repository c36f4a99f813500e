"""Test configuration: force an 8-device virtual CPU mesh.

Multi-chip hardware isn't available in CI; per SURVEY.md §4 the sharding
paths are validated on a virtual CPU mesh via
``xla_force_host_platform_device_count``. Must run before jax is imported.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"  # tests run on a virtual CPU mesh
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# A backend registered at interpreter start (before env vars set here can
# take effect) would win over the variable -- force the platform through
# the live config as well.
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def tiny_cfg():
    from sessionsimilaritysearch.config import tiny_test_config

    return tiny_test_config()


@pytest.fixture(scope="session")
def tokenizer(tiny_cfg):
    from sessionsimilaritysearch.tokenizer import get_tokenizer

    return get_tokenizer(vocab_size=tiny_cfg.vocab_size)


@pytest.fixture(scope="session")
def gen(tiny_cfg):
    from sessionsimilaritysearch.data.synthetic import SyntheticSessionGenerator

    return SyntheticSessionGenerator(asin_num=tiny_cfg.asin_num, seed=0)


@pytest.fixture()
def rng():
    # function-scoped: each test gets a fresh deterministic stream, so test
    # outcomes don't depend on execution order
    return np.random.default_rng(0)
