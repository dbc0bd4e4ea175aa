"""Test harness: force JAX onto an 8-device virtual CPU mesh.

All sharding/collective logic is exercised on XLA's host platform with 8
virtual devices. Must run before any JAX backend initialization, hence
module-level in conftest. Tests marked ``gpu`` need the card: when JAX is
already imported (``chip_smoke.py`` runs them in its own process, on the GPU
it has opened) the platform is left alone, and the ``gpu`` fixture skips
them anywhere else.
"""

import os
import sys
import tempfile

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()

# keep test benchmark rows out of the benchmark_results/ record
os.environ.setdefault(
    "MPT_RESULTS_DIR", tempfile.mkdtemp(prefix="mpt_test_results_")
)

_host_chose_platform = "jax" in sys.modules

import jax  # noqa: E402

if not _host_chose_platform:
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture()
def rng():
    # function-scoped on purpose: a shared session generator couples every
    # test's data to whichever tests ran before it, so adding one test
    # silently changes others' inputs (an order-dependent flake found in
    # round 2: a k-mer test shifted the genotype test's random reference
    # into an ambiguous-insertion-placement corner)
    return np.random.default_rng(0)


@pytest.fixture()
def gpu():
    """For tests of code that runs only on the card (a CUDA kernel has no
    interpret mode): skip unless JAX's default backend is a GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: CUDA kernels have no CPU or interpret mode")


@pytest.fixture(scope="session")
def mesh8():
    return jax.make_mesh((8,), ("data",))


def random_dna(rng, n, alphabet=b"ACGT"):
    return rng.choice(np.frombuffer(alphabet, np.uint8), size=n).tobytes()
