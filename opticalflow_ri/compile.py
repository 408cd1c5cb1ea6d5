"""Whole-pipeline compilation: one XLA program per (config, image shape).

The reference executes its pipeline as dozens of host-orchestrated stages with
full host<->device copies around each (SURVEY.md section 3.5); the staged
driver in ``pyramid.py`` already keeps data on device, but still pays a
dispatch per stage.  This module traces
an entire calibrated configuration — pyramid levels, filters, warps, solver
iterations, optional refiner — into a single jitted program, so running a pair
is ONE dispatch.  Adapter statefulness (the HS alpha list) resolves at trace
time, exactly like the reference resolves it at run time.

    fn = compiled_pipeline("PyHSchunck_Fs3_4")
    U, V = fn(im1, im2)                      # one XLA execution

Batched throughput uses ``scan_pipeline`` (one dispatch, pairs processed
sequentially on device with the single-pair working set); the vmapped
``batched_pipeline`` is deprecated — see its docstring.

``configure_compile_cache`` points JAX's persistent compilation cache at a
fixed directory, so repeated runs of the same program skip the compile.
"""

from __future__ import annotations

import os
from functools import lru_cache

import jax

from opticalflow_ri.configs import build_config


def pipeline_fn(name: str):
    """A pure (im1, im2) -> (U, V) function for a named calibrated config.
    Fresh adapters are constructed per trace, so stateful calibration lists
    reset correctly."""
    cfg = build_config(name)

    def fn(im1, im2):
        return cfg.run(im1, im2)

    return fn


@lru_cache(maxsize=None)
def compiled_pipeline(name: str):
    """Jitted whole-config pipeline (cached per config name; XLA caches per
    input shape)."""
    return jax.jit(pipeline_fn(name))


@lru_cache(maxsize=None)
def batched_pipeline(name: str):
    """DEPRECATED: jitted vmapped pipeline over a leading batch axis.

    vmap multiplies the working set by the batch size, while
    ``scan_pipeline`` keeps the single-pair working set with the same
    one-dispatch amortisation.  Kept for API compatibility; use
    ``scan_pipeline`` for throughput streaming."""
    import warnings

    warnings.warn(
        "batched_pipeline (vmap) is deprecated: its working set grows with "
        "the batch; use scan_pipeline",
        DeprecationWarning, stacklevel=2,
    )
    return jax.jit(jax.vmap(pipeline_fn(name)))


@lru_cache(maxsize=None)
def scan_pipeline(name: str):
    """Jitted pipeline that processes a (K, H, W) stack of pairs
    *sequentially on device* with ``lax.scan``: one dispatch, single-pair
    working set, K x marginal-cost runtime — the production streaming
    construct."""
    fn = pipeline_fn(name)

    def scanned(im1s, im2s):
        def step(carry, pair):
            u, v = fn(pair[0], pair[1])
            return carry, (u, v)

        _, (us, vs) = jax.lax.scan(step, None, (im1s, im2s))
        return us, vs

    return jax.jit(scanned)


# fixed, in-checkout cache directory (listed in .gitignore); the path is part
# of the cache key, so it is never derived from a temp name, pid or time
DEFAULT_COMPILE_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def configure_compile_cache() -> str:
    """Enable JAX's persistent compilation cache; returns its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
    sets nothing.  Otherwise the cache goes to ``DEFAULT_COMPILE_CACHE_DIR``.
    Call before the first compile."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_COMPILE_CACHE_DIR)
    return DEFAULT_COMPILE_CACHE_DIR
