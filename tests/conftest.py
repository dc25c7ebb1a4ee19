"""
Test configuration: force the JAX CPU backend with float64 enabled and an
8-device virtual mesh, so accuracy tests reproduce the reference package's
float64 semantics and sharding tests exercise multi-device code paths
without GPU hardware.  Must run before jax is used anywhere.
"""

import os

# UF3_GPU_TESTS=1 runs the device-numerics tier (tests/
# test_gpu_numerics.py, `-m gpu`) on a real GPU: the CPU force and the
# f64 default are then left alone so f32 GPU numerics are what is
# under test.  chip_smoke.py sets it before running that tier.
GPU_TIER = os.environ.get("UF3_GPU_TESTS") == "1"

if not GPU_TIER:
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["JAX_ENABLE_X64"] = "1"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags \
        and not GPU_TIER:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

# a pytest plugin may import jax before this file runs, after which
# the environment variables above are no longer read: set the same
# choices through the config API as well
import jax  # noqa: E402

if not GPU_TIER:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

# --- smoke tier -----------------------------------------------------
# `pytest -m smoke` is the fast CI gate (< 5 min): one golden per
# layer (composition / knots+basis / featurization goldens / fit /
# calculator / parsers) plus device-path exactness on the fused pair
# kernels.  The full suite (~1 h single process) stays the release
# gate.
SMOKE_MODULES = {
    "test_composition",
    "test_bsplines",
    "test_geometry_distances",
    "test_least_squares",
    "test_io",
    "test_representation",
    "test_calculator",
}
SMOKE_CLASSES = {
    ("test_fused_kernels", "TestPairKernels"),
    ("test_fused_kernels", "TestCardinalBasis"),
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "smoke: fast tier (one golden per layer, < 5 min)")
    config.addinivalue_line(
        "markers", "gpu: device-numerics tier (needs a GPU; run "
                   "through chip_smoke.py, or UF3_GPU_TESTS=1 "
                   "pytest -m gpu)")


def pytest_collection_modifyitems(config, items):
    for item in items:
        mod = os.path.splitext(os.path.basename(str(item.fspath)))[0]
        cls = item.cls.__name__ if item.cls is not None else None
        if mod in SMOKE_MODULES or (mod, cls) in SMOKE_CLASSES:
            item.add_marker(pytest.mark.smoke)


@pytest.fixture(scope="session")
def data_dir():
    return os.path.join(os.path.dirname(__file__), "data")


@pytest.fixture(autouse=True)
def _clear_jax_caches():
    """Drop live compiled executables after every test.

    XLA:CPU (jaxlib 0.9.0) segfaults inside backend_compile once many
    large fused-MD executables accumulate in one process (reproduced
    deterministically at the 9th big compile in test_device_potential;
    crash is inside libc called from the compiler, independent of
    stack rlimit, codegen splitting, and TSD-key counts).  Clearing
    jax's executable caches between tests keeps the live-module count
    low and was verified to make the same sequence pass.  Costs some
    recompilation for fixtures shared across tests; correctness is
    unaffected.
    """
    yield
    jax.clear_caches()
