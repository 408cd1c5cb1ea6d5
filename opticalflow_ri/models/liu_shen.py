"""Liu-Shen physics-based optical flow (continuity-equation refiner).

Functional re-design of the reference implementation
(ref: src/PhysicsBasedOpticalFlowLiuShen.py).  The fixed-point iteration —
twelve 3x3 stencils assembling (bu, bv) plus the 2x2-inverse update — runs
inside one jitted ``lax.while_loop`` (tolerance 1e-8, max 60 iterations,
ref: :88-89,:141), so each iteration is a fused pass on device with no host
round trips, unlike the reference's per-iteration scipy convolutions (ref: :142-148).

Numerics parity notes:
  * all stencils are correlations with the original MATLAB kernels — the
    reference flips them (ref: :116-121) precisely so scipy's convolve becomes
    correlation; we correlate directly;
  * border modes: 'nearest' (replicate) everywhere except the H-kernel terms
    and the cmtx neighbour-count field, which use zero padding (ref: :61,:144);
  * both frames are normalised by their own global maxima (ref: :96-97) — on
    a sharded run this becomes a psum-style global reduction;
  * the solver's "u" axis is image *rows*; the adapter swaps components on the
    way in and out exactly like the reference (ref: :37-39).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from opticalflow_ri.ops import resolve_impl
from opticalflow_ri.ops.padding import pad2d
from opticalflow_ri.ops.stencil import correlate3x3

# Original (MATLAB-orientation) kernels; applied as correlations.
_K_D1 = np.array([[0, -1, 0], [0, 0, 0], [0, 1, 0]], np.float32) / 2.0   # d/drow
_K_D2 = _K_D1.T                                                          # d/dcol
_K_F1 = np.array([[0, 1, 0], [0, 0, 0], [0, 1, 0]], np.float32)          # row-neighbour sum
_K_F2 = _K_F1.T
_K_M = np.array([[1, 0, -1], [0, 0, 0], [-1, 0, 1]], np.float32) / 4.0   # mixed derivative
_K_D2ND = np.array([[0, 1, 0], [0, -2, 0], [0, 1, 0]], np.float32)       # 2nd deriv (rows)
_K_H = np.array([[1, 1, 1], [1, 0, 1], [1, 1, 1]], np.float32)           # 8-neighbour sum


def _d1(x):
    return correlate3x3(x, _K_D1, "nearest")


def _d2(x):
    return correlate3x3(x, _K_D2, "nearest")


def liu_shen_precompute(im1, im2, h):
    """Iteration-invariant fields: image products, RHS constants and the
    per-pixel 2x2 inverse system (ref: :47-73, :124-128)."""
    iix = im1 * _d1(im1)
    iiy = im1 * _d2(im1)
    ii = im1 * im1
    dt = im2 - im1
    ixt = im1 * _d1(dt)
    iyt = im1 * _d2(dt)

    h = jnp.float32(h)
    cmtx = correlate3x3(jnp.ones_like(im1), _K_H, "constant")
    a11 = im1 * (correlate3x3(im1, _K_D2ND, "nearest") - 2.0 * im1) - h * cmtx
    a22 = im1 * (correlate3x3(im1, _K_D2ND.T, "nearest") - 2.0 * im1) - h * cmtx
    a12 = im1 * correlate3x3(im1, _K_M, "nearest")
    det = a11 * a22 - a12 * a12
    b11 = a22 / det
    b12 = -a12 / det
    b22 = a11 / det
    return (iix, iiy, ii, ixt, iyt, b11, b12, b22)


def ls_field_stencils(zp, out_h: int, out_w: int):
    """(d1, d2, f1, f2, m) for one field from a single 1-px-padded copy.

    ``zp`` carries a nearest-border pad (or a halo-exchanged apron on the
    sharded path).  The mixed-derivative kernel _K_M is rank-1
    ([1,0,-1]⊗[1,0,-1]/4), so it is computed as a column difference of a row
    difference — 3 ops instead of the 4-tap sum."""
    c = lambda dy, dx: zp[..., 1 + dy : 1 + dy + out_h, 1 + dx : 1 + dx + out_w]
    half = jnp.float32(0.5)
    d1 = (c(1, 0) - c(-1, 0)) * half
    d2 = (c(0, 1) - c(0, -1)) * half
    f1 = c(-1, 0) + c(1, 0)
    f2 = c(0, -1) + c(0, 1)
    rdiff = zp[..., :, 2:] - zp[..., :, :-2]
    m = (rdiff[..., 2:, :] - rdiff[..., :-2, :]) * jnp.float32(0.25)
    return d1, d2, f1, f2, m


def ls_ring_sum(zp, out_h: int, out_w: int):
    """8-neighbour sum (_K_H) from a zero-padded copy, in separable form:
    [1,1,1]⊗[1,1,1] − δ — two 3-tap passes + a centre correction instead of
    the 8-tap sum."""
    p = zp[..., :-2, :] + zp[..., 1:-1, :] + zp[..., 2:, :]
    q = p[..., :, :out_w] + p[..., :, 1 : out_w + 1] + p[..., :, 2 : out_w + 2]
    return q - zp[..., 1 : out_h + 1, 1 : out_w + 1]


def liu_shen_iteration(u, v, fields, h):
    """One fixed-point update (ref: :142-150); the sharded halo-exchange
    path mirrors this exact op structure."""
    iix, iiy, ii, ixt, iyt, b11, b12, b22 = fields
    h = jnp.float32(h)
    oh, ow = u.shape[-2], u.shape[-1]
    du1, du2, fu1, _, mu = ls_field_stencils(pad2d(u, 1, "nearest"), oh, ow)
    dv1, dv2, _, fv2, mv = ls_field_stencils(pad2d(v, 1, "nearest"), oh, ow)
    ring_u = ls_ring_sum(pad2d(u, 1, "constant"), oh, ow)
    ring_v = ls_ring_sum(pad2d(v, 1, "constant"), oh, ow)
    bu = iix * (2.0 * du1 + dv2) + iiy * dv1 + ii * (fu1 + mv) + h * ring_u + ixt
    bv = iiy * (du1 + 2.0 * dv2) + iix * du2 + ii * (mu + fv2) + h * ring_v + iyt
    u_new = -(b11 * bu + b12 * bv)
    v_new = -(b12 * bu + b22 * bv)
    return u_new, v_new


@partial(jax.jit, static_argnames=("max_iter", "tol", "impl"))
def liu_shen_solve(im1, im2, h, u0, v0, max_iter: int = 60, tol: float = 1e-8,
                   impl: str = "auto"):
    """Run the Liu-Shen fixed-point solve.  Component convention matches the
    reference's internal one (u along rows); see the adapter for the swap.
    ``impl``: "xla" (the ``while_loop``); "auto" resolves to it."""
    resolve_impl(impl)
    im1 = im1.astype(jnp.float32)
    im2 = im2.astype(jnp.float32)
    im1 = im1 / jnp.max(im1)
    im2 = im2 / jnp.max(im2)

    fields = liu_shen_precompute(im1, im2, h)

    npix = jnp.float32(im1.shape[-2] * im1.shape[-1])

    def cond(state):
        _, _, err, k = state
        return jnp.logical_and(err > tol, k < max_iter)

    def body(state):
        u, v, _, k = state
        u_new, v_new = liu_shen_iteration(u, v, fields, h)
        err = (jnp.linalg.norm(u_new - u) + jnp.linalg.norm(v_new - v)) / npix
        return (u_new, v_new, err, k + 1)

    init = (u0.astype(jnp.float32), v0.astype(jnp.float32), jnp.float32(1e8), 0)
    u, v, err, k = lax.while_loop(cond, body, init)
    err = jnp.where(k > 0, err, jnp.float32(0.0))
    return u, v, err


class LiuShenOpticalFlowAlgoAdapter:
    """Driver adapter; swaps flow components in/out like the reference
    (ref: src/PhysicsBasedOpticalFlowLiuShen.py:37-39)."""

    def __init__(self, alpha):
        self.alpha = alpha

    def compute(self, im1, im2, U, V):
        im1 = jnp.asarray(im1)
        rv, ru, err = liu_shen_solve(
            im1, jnp.asarray(im2), float(self.alpha),
            jnp.asarray(V), jnp.asarray(U),
        )
        return [ru, rv, err]

    def getAlgoName(self):
        return "Liu-Shen Physics based OF"

    def hasGenericPyramidalDefaults(self):
        return False
