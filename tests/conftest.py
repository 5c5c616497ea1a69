"""Test harness: run everything on a virtual 8-device CPU mesh.

Sharding correctness is validated on ``xla_force_host_platform_device_count=8``
CPU devices; ``__graft_entry__.py multichip`` dry-runs the same path.  The
GPU lane (``-m gpu``, tests/test_gpu_lane.py) runs on the card with
``SDPL_TEST_PLATFORM=gpu`` and skips elsewhere.  Must set env BEFORE
importing jax anywhere.
"""

import os
import time

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# hermetic persisted-BA-floors store (ba_builder.persist_floors): a
# per-suite-run file so no state leaks between CI runs or from the
# developer's ~/.cache into tests; subprocess-isolated tests inherit it
os.environ.setdefault(
    "SDPL_BA_FLOORS",
    "/tmp/sdpl_ba_floors_test_%d_%d.json" % (os.getpid(), time.time_ns()),
)

# The CPU suite's wall time is dominated by XLA:CPU compilation (the
# persistent compile cache is unusable here -- see the note below).
# Skipping XLA's expensive optimization passes cuts measured module
# times ~35-40 % with no test-visible numeric change (the LLVM backend
# still vectorizes); the GPU lane keeps full optimization.  Must be in
# the environment BEFORE jax import.  The execution-bound KITTI-scale
# subprocess tests strip it from their child env (unfused plane ops at
# 1242x375 cost more than the compiles saved -- test_chained_kitti.py).
if os.environ.get("SDPL_TEST_PLATFORM", "cpu") == "cpu":
    os.environ.setdefault("JAX_DISABLE_MOST_OPTIMIZATIONS", "1")

import jax  # noqa: E402

# Tests run on the virtual CPU mesh by default, whatever accelerator the
# host has.  The GPU lane (-m gpu, test_gpu_lane.py) is run with
# SDPL_TEST_PLATFORM=gpu to keep the real backend.
if os.environ.get("SDPL_TEST_PLATFORM", "cpu") == "cpu":
    jax.config.update("jax_platforms", "cpu")
    # NOTE: do NOT enable the persistent XLA compile cache here.  It was
    # tried for suite wall time: the CPU AOT loader records tuning
    # pseudo-features (prefer-no-scatter/gather) that the runtime host
    # check does not report, and cache READS can hard-abort the process
    # (observed: Fatal Python error: Aborted inside
    # compilation_cache.get_executable_and_time) -- which is why the
    # package root leaves the CPU backend uncached.

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _gpu_lane(request):
    """Skip ``gpu``-marked tests unless the backend is a GPU.  Decided per
    test, never at collection, so every xdist worker collects the same
    tests."""
    if (request.node.get_closest_marker("gpu") is not None
            and jax.default_backend() != "gpu"):
        pytest.skip("GPU lane: needs a GPU backend (run on the card with "
                    "`python chip_smoke.py`)")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


# Modules whose jit programs are both LARGE and module-local (the BA
# solvers and the line-detector sweeps).  A single long-lived process
# accumulating every module's XLA:CPU programs has been observed to
# destabilize late compiles (segfault inside backend_compile_and_load on
# the largest program of the run); purging after these modules keeps
# compiler state bounded WITHOUT evicting the tracking/detector programs
# shared by the many System-loop modules (a blanket per-module clear
# added ~7 min of recompiles).
_HEAVY_MODULES = {
    "test_batch_ba", "test_schur_ba", "test_sharded_ba",
    "test_lines", "test_line_recall", "test_lsd_oracle",
}


@pytest.fixture(autouse=True, scope="module")
def _clear_jit_caches_after_heavy(request):
    yield
    if request.module.__name__ in _HEAVY_MODULES:
        jax.clear_caches()
