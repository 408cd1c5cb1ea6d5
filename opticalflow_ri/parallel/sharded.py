"""Spatially-sharded solvers: shard_map + halo exchange + psum reductions.

Each solver here is numerically identical to its single-device counterpart in
``models/`` — sharding tests assert the N-way-sharded run matches the
1-device run — but executes SPMD over a ('batch', 'y', 'x') mesh:

  * image tiles live on devices; every Jacobi/fixed-point iteration exchanges
    a 1-px halo with its 4 neighbours (lax.ppermute);
  * global scalars (Frobenius error norms, image maxima) are psum/pmax
    collectives;
  * whole image pairs batch over the 'batch' axis (pure data parallelism).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P
from jax import shard_map

from opticalflow_ri.parallel.halo import exchange_halo
from opticalflow_ri.models import liu_shen as ls
from opticalflow_ri.ops.stencil import correlate3x3_padded, hs_avg3x3_padded
from opticalflow_ri.ops.gaussian import prepare_gaussian_kernel

_SPATIAL = ("y", "x")


def _hs_derivatives_local(im1, im2):
    """HS 2x2 derivative stencils on local tiles: +1 halo bottom/right with
    the global mirror rule (cf. ops.stencil.hs_derivatives)."""

    def quads(im):
        p = exchange_halo(im, ((0, 1), (0, 1)), "mirror")
        h = im.shape[-2]
        w = im.shape[-1]
        return (
            p[..., :h, :w], p[..., :h, 1 : w + 1],
            p[..., 1 : h + 1, :w], p[..., 1 : h + 1, 1 : w + 1],
        )

    a1, b1, c1, d1 = quads(im1)
    a2, b2, c2, d2 = quads(im2)
    quarter = jnp.float32(0.25)
    fx = (a1 - b1 + c1 - d1 + a2 - b2 + c2 - d2) * quarter
    fy = (a1 + b1 - c1 - d1 + a2 + b2 - c2 - d2) * quarter
    ft = (a1 + b1 + c1 + d1 - a2 - b2 - c2 - d2) * quarter
    return fx, fy, ft


def _corr3_sharded(z, kernel, mode):
    zp = exchange_halo(z, 1, mode)
    return correlate3x3_padded(zp, kernel, z.shape[-2], z.shape[-1])


def _global_sum(z):
    # sum over the spatial (trailing) dims only, then all-reduce over the
    # spatial mesh axes — keeps per-batch-element scalars separate
    return lax.psum(jnp.sum(z, axis=(-2, -1)), _SPATIAL)


def _hs_body(im1, im2, u0, v0, *, alpha, niter):
    fx, fy, ft = _hs_derivatives_local(im1, im2)
    alpha = jnp.float32(alpha)
    rdenom = 1.0 / (alpha * alpha + fx * fx + fy * fy)

    def _avg(z):
        zp = exchange_halo(z, 1, "mirror")
        return hs_avg3x3_padded(zp, z.shape[-2], z.shape[-1])

    def body(_, uv):
        u, v = uv
        u_avg = _avg(u)
        v_avg = _avg(v)
        der = (fx * u_avg + fy * v_avg + ft) * rdenom
        return (u_avg - fx * der, v_avg - fy * der)

    u, v = lax.fori_loop(0, niter, body, (u0, v0))

    npix = _global_sum(jnp.ones_like(u))
    err = (
        jnp.sqrt(_global_sum((u - u0) ** 2)) + jnp.sqrt(_global_sum((v - v0) ** 2))
    ) / npix
    return u, v, err


def _avg3x3_wrap(x):
    """Border-free 3x3 neighbour average with wraparound: the wrapped cells
    are stale-halo garbage that the T-deep halo keeps out of the crop.
    Separable form: 1/12·[[1,2,1],[2,0,2],[1,2,1]] = ([1,2,1]⊗[1,2,1]
    − 4·δ)/12."""
    two = jnp.float32(2.0)
    p = jnp.roll(x, 1, axis=-1) + two * x + jnp.roll(x, -1, axis=-1)
    q = jnp.roll(p, 1, axis=-2) + two * p + jnp.roll(p, -1, axis=-2)
    return (q - jnp.float32(4.0) * x) * jnp.float32(1.0 / 12.0)


def _hs_body_tblocked(im1, im2, u0, v0, *, alpha, niter, t_block):
    """Temporal-blocked variant of _hs_body: T Jacobi iterations per halo
    exchange instead of one.  Each outer step exchanges a T-deep halo (global
    borders synthesise a T-deep mirror ring — the Jacobi operator preserves
    mirror symmetry, so the ring evolves exactly like its interior image for
    T iterations), runs T wraparound stencil iterations on the padded tile
    (edge garbage creeps 1 px/iteration and never crosses the halo) and
    crops.  Collective count drops from ``niter`` ppermute rounds to
    ``ceil(niter / t_block)``."""
    fx, fy, ft = _hs_derivatives_local(im1, im2)
    alpha = jnp.float32(alpha)
    rd = 1.0 / (alpha * alpha + fx * fx + fy * fy)

    t = int(t_block)
    # constants padded once (they do not evolve -> no staleness)
    fxp = exchange_halo(fx, t, "mirror")
    fyp = exchange_halo(fy, t, "mirror")
    ftp = exchange_halo(ft, t, "mirror")
    rdp = exchange_halo(rd, t, "mirror")
    h = im1.shape[-2]
    w = im1.shape[-1]

    def inner(_, uv):
        u, v = uv
        u_avg = _avg3x3_wrap(u)
        v_avg = _avg3x3_wrap(v)
        der = (fxp * u_avg + fyp * v_avg + ftp) * rdp
        return (u_avg - fxp * der, v_avg - fyp * der)

    u, v = u0, v0
    done = 0
    while done < niter:
        k = min(t, niter - done)
        up = exchange_halo(u, t, "mirror")
        vp = exchange_halo(v, t, "mirror")
        up, vp = lax.fori_loop(0, k, inner, (up, vp))
        u = up[..., t : t + h, t : t + w]
        v = vp[..., t : t + h, t : t + w]
        done += k

    npix = _global_sum(jnp.ones_like(u))
    err = (
        jnp.sqrt(_global_sum((u - u0) ** 2)) + jnp.sqrt(_global_sum((v - v0) ** 2))
    ) / npix
    return u, v, err


def hs_solve_sharded_tblocked(mesh, im1, im2, alpha, niter, u0, v0,
                              t_block: int = 10):
    """Temporal-blocked spatially-sharded Horn-Schunck: same numerics as
    hs_solve_sharded (to f32 round-off) with t_block x fewer collective
    rounds.  ``t_block`` must not exceed the local tile extent."""
    spec = P("y", "x")

    @partial(jax.jit, static_argnames=("niter", "t_block"))
    def run(im1, im2, u0, v0, niter, t_block):
        f = shard_map(
            partial(_hs_body_tblocked, niter=niter, alpha=alpha,
                    t_block=t_block),
            mesh=mesh,
            in_specs=(spec, spec, spec, spec),
            out_specs=(spec, spec, P()),
            check_vma=False,
        )
        return f(
            im1.astype(jnp.float32), im2.astype(jnp.float32),
            u0.astype(jnp.float32), v0.astype(jnp.float32),
        )

    return run(im1, im2, u0, v0, niter, t_block)


def hs_solve_sharded(mesh, im1, im2, alpha, niter, u0, v0):
    """Spatially-sharded Horn-Schunck; same numerics as models.horn_schunck.
    Arrays are (H, W), sharded over ('y', 'x')."""
    spec = P("y", "x")

    @partial(jax.jit, static_argnames=("niter",))
    def run(im1, im2, u0, v0, niter):
        f = shard_map(
            partial(_hs_body, niter=niter, alpha=alpha),
            mesh=mesh,
            in_specs=(spec, spec, spec, spec),
            out_specs=(spec, spec, P()),
            check_vma=False,
        )
        return f(
            im1.astype(jnp.float32), im2.astype(jnp.float32),
            u0.astype(jnp.float32), v0.astype(jnp.float32),
        )

    return run(im1, im2, u0, v0, niter)


# ---------------------------------------------------------------------------
# Liu-Shen
# ---------------------------------------------------------------------------

def _ls_body(im1, im2, u0, v0, *, h_reg, max_iter, tol=1e-8):
    im1 = im1 / lax.pmax(jnp.max(im1), _SPATIAL)
    im2 = im2 / lax.pmax(jnp.max(im2), _SPATIAL)
    h_reg = jnp.float32(h_reg)

    c = _corr3_sharded
    iix = im1 * c(im1, ls._K_D1, "nearest")
    iiy = im1 * c(im1, ls._K_D2, "nearest")
    ii = im1 * im1
    dt = im2 - im1
    ixt = im1 * c(dt, ls._K_D1, "nearest")
    iyt = im1 * c(dt, ls._K_D2, "nearest")

    cmtx = c(jnp.ones_like(im1), ls._K_H, "constant")
    a11 = im1 * (c(im1, ls._K_D2ND, "nearest") - 2.0 * im1) - h_reg * cmtx
    a22 = im1 * (c(im1, ls._K_D2ND.T, "nearest") - 2.0 * im1) - h_reg * cmtx
    a12 = im1 * c(im1, ls._K_M, "nearest")
    det = a11 * a22 - a12 * a12
    b11, b12, b22 = a22 / det, -a12 / det, a11 / det

    npix = _global_sum(jnp.ones_like(im1))

    def iteration(u, v):
        # 4 halo exchanges per iteration (one nearest + one zero-border apron
        # per field) instead of one per stencil; stencil math mirrors
        # models.liu_shen.liu_shen_iteration exactly.
        oh, ow = u.shape[-2], u.shape[-1]
        du1, du2, fu1, _, mu = ls.ls_field_stencils(
            exchange_halo(u, 1, "nearest"), oh, ow)
        dv1, dv2, _, fv2, mv = ls.ls_field_stencils(
            exchange_halo(v, 1, "nearest"), oh, ow)
        ring_u = ls.ls_ring_sum(exchange_halo(u, 1, "constant"), oh, ow)
        ring_v = ls.ls_ring_sum(exchange_halo(v, 1, "constant"), oh, ow)
        bu = (iix * (2.0 * du1 + dv2) + iiy * dv1 + ii * (fu1 + mv)
              + h_reg * ring_u + ixt)
        bv = (iiy * (du1 + 2.0 * dv2) + iix * du2 + ii * (mu + fv2)
              + h_reg * ring_v + iyt)
        return -(b11 * bu + b12 * bv), -(b12 * bu + b22 * bv)

    def cond(state):
        _, _, err, k = state
        return jnp.logical_and(err > tol, k < max_iter)

    def body(state):
        u, v, _, k = state
        un, vn = iteration(u, v)
        err = (
            jnp.sqrt(_global_sum((un - u) ** 2)) + jnp.sqrt(_global_sum((vn - v) ** 2))
        ) / npix
        return (un, vn, err, k + 1)

    u, v, err, k = lax.while_loop(cond, body, (u0, v0, jnp.float32(1e8), 0))
    return u, v, jnp.where(k > 0, err, 0.0)


def liu_shen_solve_sharded(mesh, im1, im2, h_reg, u0, v0, max_iter=60):
    """Spatially-sharded Liu-Shen fixed-point solve (internal component
    convention; see models.liu_shen adapter for the swap)."""
    spec = P("y", "x")

    @partial(jax.jit, static_argnames=("max_iter",))
    def run(im1, im2, u0, v0, max_iter):
        f = shard_map(
            partial(_ls_body, h_reg=h_reg, max_iter=max_iter),
            mesh=mesh,
            in_specs=(spec, spec, spec, spec),
            out_specs=(spec, spec, P()),
            check_vma=False,
        )
        return f(
            im1.astype(jnp.float32), im2.astype(jnp.float32),
            u0.astype(jnp.float32), v0.astype(jnp.float32),
        )

    return run(im1, im2, u0, v0, max_iter)


# ---------------------------------------------------------------------------
# Batched end-to-end pipeline (dp over 'batch' + 2-D spatial decomposition)
# ---------------------------------------------------------------------------

def _prefilter_local(im, sigma, ksize):
    kernel = prepare_gaussian_kernel(sigma, ksize)
    half = ksize // 2
    p = exchange_halo(im, ((0, 0), (half, half)), "symmetric")
    w = im.shape[-1]
    out = None
    for j in range(ksize):
        t = p[..., :, j : j + w] * jnp.float32(kernel[j])
        out = t if out is None else out + t
    p = exchange_halo(out, ((half, half), (0, 0)), "symmetric")
    h = im.shape[-2]
    out2 = None
    for i in range(ksize):
        t = p[..., i : i + h, :] * jnp.float32(kernel[i])
        out2 = t if out2 is None else out2 + t
    return out2


def batched_hs_pipeline(mesh, im1, im2, alpha=21.0, niter=10, filter_sigma=3.4):
    """One full flow-computation step on a batch of image pairs: calibrated
    pre-filter + HS derivatives + Jacobi iterations + global error, SPMD over
    ('batch', 'y', 'x').  This is the flagship multi-chip step."""
    spec = P("batch", "y", "x")

    def step(im1, im2):
        im1 = im1.astype(jnp.float32)
        im2 = im2.astype(jnp.float32)
        if filter_sigma > 1e-3:
            im1 = _prefilter_local(im1, filter_sigma, 3)
            im2 = _prefilter_local(im2, filter_sigma, 3)
        z = jnp.zeros_like(im1)
        return _hs_body(im1, im2, z, z, alpha=alpha, niter=niter)

    @jax.jit
    def run(im1, im2):
        f = shard_map(
            step, mesh=mesh, in_specs=(spec, spec),
            out_specs=(spec, spec, P("batch")),
            check_vma=False,
        )
        return f(im1, im2)

    return run(im1, im2)
