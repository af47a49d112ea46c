"""Test configuration: force an 8-device CPU mesh so multi-device sharding
logic (client shards, distributed BA collectives) is exercised hermetically on
one machine — the analog of the reference's roscore-on-localhost
multi-process testing (ref: README.md:55-75).

Tests marked `chip` need an NVIDIA GPU and skip here; `python chip_smoke.py`
runs the same checks on the card."""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

# The environment variable alone does not override a platform pinned
# elsewhere in the process; the config update does.
jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs an NVIDIA GPU (run on the card by chip_smoke.py)")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """The first GPU, or a skip: decided when a test runs, never at import."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU; run `python chip_smoke.py` on the card")
    return dev


# NO persistent compilation cache for the suite. Two observed failure
# modes make it a liability here: (a) XLA:CPU AOT entries embed the compile
# host's feature set and the container migrates across machine types
# (cpu_aot_loader feature-mismatch warnings, then SIGSEGV on load); (b)
# even same-host, deserializing cached executables into a long-lived
# process that has already loaded 100+ programs segfaulted reproducibly
# (compilation_cache.get_executable_and_time) while the identical tests
# pass in isolation. CPU compiles of these programs are cheap; always
# compiling is deterministic.
jax.config.update("jax_enable_compilation_cache", False)
os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)
