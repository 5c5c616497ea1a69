"""SDPL-SLAM in JAX: a dynamic point-line RGB-D SLAM framework.

A from-scratch JAX/XLA rebuild with the capabilities of SDPL-SLAM
(semantic dynamic point-line SLAM): per-frame camera pose estimation, SE(3)
rigid-motion estimation of every moving object, and a map of 3D points and
3D (Pluecker) lines -- all expressed as batched, statically-shaped tensor
programs that XLA compiles for the GPU, instead of the reference's scalar
per-feature C++ loops.

Layout
------
- ``ops``       : geometry / Lie-group math, feature kernels (FAST, lines),
                  flow gathers, RANSAC -- the device compute vocabulary.
- ``solvers``   : batched Levenberg-Marquardt per-frame solvers (joint
                  flow+pose, joint flow+object-motion) and the batch
                  bundle-adjustment back-end (windowed + full sequence).
- ``models``    : the SLAM pipeline state machines (Frame, Map, Tracking,
                  System facade) mirroring the reference public API.
- ``parallel``  : jax.sharding Mesh utilities and the sharded global BA.
- ``io``        : dataset loaders (KITTI/OMD formats), output writers,
                  host->device prefetch.
- ``utils``     : config (yaml, same keys as the reference), timing, metrics.
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax

# Metric SLAM geometry needs full-f32 matrix products: on Hopper, XLA's
# default precision runs f32 matmuls in TF32 (~3 decimal digits), which
# corrupts pose compositions.  Kernels that genuinely want a lower
# precision must request it explicitly.
_jax.config.update("jax_default_matmul_precision", "float32")

# Persistent compile cache location on accelerator backends: fixed, inside
# the checkout (listed in .gitignore), so every process of this checkout
# finds what an earlier one compiled.
CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache",
)


def maybe_enable_persistent_cache():
    """Point JAX's persistent compile cache at ``CACHE_DIR`` on an
    accelerator backend; returns the directory it set, else None.

    Leaves JAX alone when a cache directory is already configured
    (``JAX_COMPILATION_CACHE_DIR``, or the caller's own setting), and on the
    CPU backend: CPU AOT artifacts record tuning pseudo-features that the
    runtime host check does not report, and reading them back has aborted
    the process (tests/conftest.py).  Called lazily (System construction)
    because deciding needs the backend, and initializing the backend at
    import would break platform-pinning callers.  Idempotent."""
    if _jax.config.jax_compilation_cache_dir:
        return None
    if _jax.default_backend() == "cpu":
        return None
    _os.makedirs(CACHE_DIR, exist_ok=True)
    _jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR
