"""Horn-Schunck global-smoothness optical flow.

Functional re-design of the reference's Numba/scipy implementation
(ref: src/HornSchunck.py): the whole Jacobi relaxation — neighbour-weighted
averaging plus the fused update — runs as a single jitted ``lax.fori_loop``
so every iteration is one fused elementwise pass on device instead of the
reference's per-iteration scipy convolution + Numba kernel round trip
(ref: src/HornSchunck.py:62-71).

Numerics parity notes:
  * the derivative stencils and the frame-role swap quirk
    (ref: src/HornSchunck.py:37 calls HS(im1, im2, ...) whose parameters are
    declared (im2, im1, ...)) are folded into ``ops.stencil.hs_derivatives``;
  * the 3x3 averaging kernel [[1/12,1/6,1/12],[1/6,0,1/6],[1/12,1/6,1/12]]
    and its 'mirror' border match ref: src/HornSchunck.py:87-89, :66-68;
  * the denominator alpha^2 + fx^2 + fy^2 is iteration-invariant and hoisted;
  * the returned scalar error is the same normalised Frobenius delta between
    the final flow and the *input* flow (ref: src/HornSchunck.py:100);
  * the adapter keeps the reference's stateful alpha-list pop semantics —
    one alpha consumed per compute() call, last-constructed first, so the
    coarsest pyramid level receives the final list entry
    (ref: src/HornSchunck.py:36).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from opticalflow_ri.ops import resolve_impl
from opticalflow_ri.ops.stencil import hs_avg3x3, hs_derivatives

HS_AVG_KERNEL = np.array(
    [
        [1.0 / 12, 1.0 / 6, 1.0 / 12],
        [1.0 / 6, 0.0, 1.0 / 6],
        [1.0 / 12, 1.0 / 6, 1.0 / 12],
    ],
    dtype=np.float32,
)


@partial(jax.jit, static_argnames=("niter", "impl"))
def hs_solve(im1, im2, alpha, niter: int, u0, v0, impl: str = "auto"):
    """Run ``niter`` Jacobi iterations; returns (U, V, error).

    ``im1``/``im2`` are frames at t=0/t=1 (driver order); the temporal
    derivative sign convention matches the reference's effective computation.
    ``impl``: "xla" (the fused ``fori_loop``); "auto" resolves to it.
    """
    im1 = im1.astype(jnp.float32)
    im2 = im2.astype(jnp.float32)
    u0 = u0.astype(jnp.float32)
    v0 = v0.astype(jnp.float32)
    alpha = jnp.float32(alpha)

    resolve_impl(impl)
    fx, fy, ft = hs_derivatives(im1, im2)

    # reciprocal hoisted out of the loop (f32 division costs a reciprocal +
    # Newton steps per iteration otherwise); separable neighbour average —
    # see ops.stencil.hs_avg3x3
    rdenom = 1.0 / (alpha * alpha + fx * fx + fy * fy)

    def body(_, uv):
        u, v = uv
        u_avg = hs_avg3x3(u, "mirror")
        v_avg = hs_avg3x3(v, "mirror")
        der = (fx * u_avg + fy * v_avg + ft) * rdenom
        return (u_avg - fx * der, v_avg - fy * der)

    u, v = lax.fori_loop(0, niter, body, (u0, v0))

    npix = im1.shape[-2] * im1.shape[-1]
    err = (
        jnp.linalg.norm(u - u0) + jnp.linalg.norm(v - v0)
    ) / jnp.float32(npix)
    return u, v, err


class HSOpticalFlowAlgoAdapter:
    """Driver adapter with reference-identical protocol and alpha-list state."""

    def __init__(self, alphas, Niter: int, provideGenericPyramidalDefaults: bool = True):
        self.provideGenericPyramidalDefaults = provideGenericPyramidalDefaults
        self.alphas = list(alphas)
        self.Niter = int(Niter)

    def compute(self, im1, im2, U, V):
        alpha = self.alphas.pop()
        im1 = jnp.asarray(im1)
        u, v, err = hs_solve(
            im1, jnp.asarray(im2), float(alpha), self.Niter,
            jnp.asarray(U), jnp.asarray(V),
        )
        return u, v, err

    def getAlgoName(self):
        return "Horn-Schunck"

    def hasGenericPyramidalDefaults(self):
        return self.provideGenericPyramidalDefaults

    def getGenericPyramidalDefaults(self):
        return {"warping": True, "biLinear": True, "scaling": True}
