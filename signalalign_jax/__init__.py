"""signalalign_jax — nanopore signal-to-reference alignment on JAX/XLA.

A from-scratch re-design of the capabilities of UCSC-nanopore-cgl/signalAlign
(banded pair-HMM posterior decoding of ONT ionic-current events against a
reference k-mer sequence, HDP-mixture emissions for methylation calling, and
Baum-Welch/EM training) built on JAX/XLA and run on NVIDIA GPUs.

Key architectural differences from the reference (C99 + subprocess pipelines):

* The banded forward-backward DP over (reference-kmer x event) cells
  (reference: impl/pairwiseAligner.c) is a fixed-shape band-tensor program
  swept along anti-diagonals with ``jax.lax.scan``, batched over many reads
  per device.
* Emissions (Gaussian, inverse-Gaussian, HDP spline densities; reference:
  impl/stateMachine.c, impl/hdp.c) are vectorized table lookups and
  elementwise math.
* Per-read process pools (reference: utils/multithread.py + signalMachine
  subprocesses) are replaced by device batching over every local device and
  ``jax.sharding`` data parallelism over a device mesh; EM expectation
  reduction (reference: per-read TSV files summed in Python) is an
  on-device ``psum``.
"""

__version__ = "0.1.0"

import os as _os

from signalalign_jax.models.pore_model import PoreModel  # noqa: F401


def compile_cache_dir(environ=_os.environ):
    """Directory this package points JAX's persistent compilation cache at.

    Kernel shapes are bucketed, so the same executables recur across runs
    and a warm cache removes most of a cold start's compile time. Returns
    None when ``JAX_COMPILATION_CACHE_DIR`` is set (JAX reads it itself)
    or ``SIGNALALIGN_NO_COMPILE_CACHE`` opts out; otherwise the fixed
    ``.jax_cache`` directory at the root of the checkout (git-ignored; a
    fixed path, because the path is part of the cache key).
    """
    if environ.get("JAX_COMPILATION_CACHE_DIR") or \
            environ.get("SIGNALALIGN_NO_COMPILE_CACHE"):
        return None
    return _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jax_cache")


_cache = compile_cache_dir()
if _cache is not None:
    import jax as _jax

    _jax.config.update("jax_compilation_cache_dir", _cache)
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
