"""Dense windowed Lucas-Kanade optical flow.

Re-designs the reference's per-pixel OpenCL Gauss-Newton kernel
(ref: src/pyrlkDenseLargeW.cl:304-669, host src/denseLucasKanade_PyCL.py)
into a gather-free, fully vectorised XLA program.  The OpenCL kernel assigns
one work-group per pixel and hardware-bilinear-samples a 27x27 (32x32-grid)
window of J at the pixel's current flow estimate every iteration — ~1k texture
reads per pixel per iteration.  Here the math is restructured instead:

**Shift-plane decomposition.**  The Gauss-Newton residual sums
    b1(p) = sum_off w(off) * [Jb(p + d(p) + off) - I(p + off)] * gx(p + off)
split into an iteration-independent constant  C1 = wsum(I * gx)  and
    S1(p) = sum_c w_c(p) * T1[s_c(p)](p),
where the bilinear sample decomposes over its 4 integer corners c, and
    T1_s(p) = sum_off w(off) * J[p + s + off] * gx(p + off)
depends only on the *integer* shift s = floor(d) + corner.  All T1_s planes
for s in [-R, R]^2 are precomputed once per compute() call as separable
weighted window sums (factor-ladder slice sums, ops/window_sums.py), and
each GN iteration reduces to a tent-weight contraction over the shift planes
(4 corners x {gx, gy} stacks) plus elementwise algebra.  Work per iteration
drops from O(H*W*win^2) texture reads to O(H*W) — the win^2 factor is paid
once, reused across iterations and shared by all pixels.

Parity notes (validated against oracle/lucas_kanade.py, which is validated
against the CL semantics):
  * CLAMP_TO_EDGE sampling == replicate padding; the sampler's -0.5 offset
    cancels at the integer patch coordinates (ref: .cl:231,:273);
  * Scharr-style gradients with weights 3/10/3 (ref: .cl:247-248);
  * window weights follow the kernel's 32-grid tile rules incl. asymmetric
    windows (ref: .cl:321-374);
  * singular windows (det < 1.192092896e-7) keep the input flow and clear
    status (ref: .cl:492-500);
  * per-pixel early exit |delta| < 0.01 and window-out-of-image bail become
    masks on a fixed trip count (ref: .cl:515-614);
  * the x32.0f delta scale (ref: .cl:604).

Divergence (documented): integer shifts are clamped to [-R, R-1]
(max_shift=R, default 5); pixels whose |flow| exceeds R px mid-iteration — far
beyond this library's <=4 px calibrated regime — would sample slightly
differently from the reference.  R=5 matches the exact (R=12) solver to
3e-5 px max on the bundled PIV pair while cutting the (2R+1)^2 shift-plane build by 28% vs the former R=6 default.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from opticalflow_ri.ops import resolve_impl
from opticalflow_ri.oracle.lucas_kanade import window_mask
from opticalflow_ri.ops.window_sums import runs_from_mask as _runs_from_mask, wsum2d as _wsum2d

_GRID = 32
_D_EPS = 1.192092896e-07
_STEP_EPS = 0.01


def lk_build_planes(slab, g_pair, runs_y, runs_x, h, w, R):
    """Shift planes: T[s] = wsum(shift_s(J) * g)  for s in [-R, R]^2, built by
    a lax.scan over the 2R+1 ROW shifts with the 2R+1 column shifts unrolled
    in the body: the body compiles once instead of (2R+1)^2 inlined copies,
    which keeps the cold compile short.  The body emits the two gradient
    stacks separately so each scan output is already the shift-major
    (nshift^2, H, W) stack.  Identical summation order.

    ``slab`` is the replicate-padded J image covering rows/cols
    [-(hw+R), {h,w}-1 + (GRID-1-hw) + R]; ``g_pair`` the (2, core_h, core_w)
    gradient stack over window offsets [-hw, GRID-1-hw]."""
    nshift = 2 * R + 1
    core_h = h + _GRID - 1
    core_w = w + _GRID - 1

    def build_row(_, sy):
        rowslab = lax.dynamic_slice(slab, (sy, 0), (core_h, core_w + 2 * R))
        # one window-sum pass per shift covers both gradient stacks
        planes = [
            _wsum2d(rowslab[:, sx : sx + core_w][None] * g_pair,
                    runs_y, runs_x, h, w)
            for sx in range(nshift)
        ]
        st = jnp.stack(planes)  # (nshift, 2, H, W)
        return None, (st[:, 0], st[:, 1])

    _, (t1s, t2s) = lax.scan(
        build_row, None, jnp.arange(nshift, dtype=jnp.int32)
    )
    t1s = t1s.reshape(nshift * nshift, h, w)  # sy-major, sx-minor
    t2s = t2s.reshape(nshift * nshift, h, w)
    return t1s, t2s


def lk_solve_fields(ipad, jpad, hw: int, R: int, runs_y, runs_x, h: int, w: int):
    """Iteration-invariant LK solve fields from the FULLY padded image pair
    (pad width hw + (GRID - hw) + R + 1 on every side): Scharr-style gradient
    stack over the window offsets, the J slab covering all integer shifts,
    the inverted structure tensor, the constant window sums, and the
    non-singular mask."""
    pad = hw + (_GRID - hw) + R + 1

    # Scharr-style gradients on the padded image (3/10/3 weights).
    def grads(p):
        gx = 3.0 * (p[:-2, 2:] + p[2:, 2:] - p[:-2, :-2] - p[2:, :-2]) + 10.0 * (
            p[1:-1, 2:] - p[1:-1, :-2]
        )
        gy = 3.0 * (p[2:, :-2] + p[2:, 2:] - p[:-2, :-2] - p[:-2, 2:]) + 10.0 * (
            p[2:, 1:-1] - p[:-2, 1:-1]
        )
        return gx, gy

    gxp, gyp = grads(ipad)  # on domain [-(pad-1), ...]

    # Core slices covering off in [-hw, GRID-1-hw] relative to each pixel.
    core_h = h + _GRID - 1
    core_w = w + _GRID - 1
    o = pad - 1 - hw  # start of off=-hw in gradient-array coords
    gx_core = lax.dynamic_slice(gxp, (o, o), (core_h, core_w))
    gy_core = lax.dynamic_slice(gyp, (o, o), (core_h, core_w))
    oi = pad - hw
    i_core = lax.dynamic_slice(ipad, (oi, oi), (core_h, core_w))

    def wsum(x):
        return _wsum2d(x, runs_y, runs_x, h, w)

    # Structure tensor (weights are 0/1 so w == w^2).
    a11 = wsum(gx_core * gx_core)
    a12 = wsum(gx_core * gy_core)
    a22 = wsum(gy_core * gy_core)
    det = a11 * a22 - a12 * a12
    ok = det >= jnp.float32(_D_EPS)
    det_safe = jnp.where(ok, det, jnp.float32(1.0))
    ia11 = a11 / det_safe
    ia12 = a12 / det_safe
    ia22 = a22 / det_safe

    c1 = wsum(i_core * gx_core)
    c2 = wsum(i_core * gy_core)

    g_pair = jnp.stack([gx_core, gy_core])  # (2, core_h, core_w)
    slab = lax.dynamic_slice(
        jpad, (oi - R, oi - R), (core_h + 2 * R, core_w + 2 * R)
    )
    return g_pair, slab, ia11, ia12, ia22, c1, c2, ok


def _lk_error_map(ipad, jpad, px, py, ok, hw, win, wgt, pad, h, w):
    """Weighted SAD error map of the final warped window — exact semantics of
    the CL kernel's GetError pass (ref: src/pyrlkDenseLargeW.cl:265-269,
    :617-667): bilinear-sample J at the post-iteration window positions over
    the 32x32 grid, quantise both operands as (x*16384+256)/512, accumulate
    weighted |diff|, divide by 32*win*win.  Pixels with a singular structure
    tensor keep err=0 (the kernel returns before writing err; the host buffer
    is zero-initialised, ref: src/denseLucasKanade_PyCL.py:146)."""
    emask = jnp.asarray(
        (window_mask(win, 0, 0)[:, None] * window_mask(win, 0, 0)[None, :]) * wgt
    )
    hp, wp = jpad.shape
    rr = jnp.arange(_GRID + 1, dtype=jnp.int32)
    quant = lambda p: ((p * 16384.0) + 256.0) / 512.0
    ipch = quant(ipad)
    jq = quant(jpad)

    block = 16 if h % 16 == 0 else h
    rows = []
    for r0 in range(0, h, block):
        pxc = px[r0 : r0 + block]
        pyc = py[r0 : r0 + block]
        x0 = jnp.floor(pxc).astype(jnp.int32)
        y0 = jnp.floor(pyc).astype(jnp.int32)
        fx = (pxc - x0)[:, :, None, None]
        fy = (pyc - y0)[:, :, None, None]
        iy = jnp.clip(y0 + pad, 0, hp - (_GRID + 1))
        ix = jnp.clip(x0 + pad, 0, wp - (_GRID + 1))
        jwin = jq[
            iy[:, :, None, None] + rr[None, None, :, None],
            ix[:, :, None, None] + rr[None, None, None, :],
        ]
        js = (
            (1 - fy) * (1 - fx) * jwin[:, :, :-1, :-1]
            + (1 - fy) * fx * jwin[:, :, :-1, 1:]
            + fy * (1 - fx) * jwin[:, :, 1:, :-1]
            + fy * fx * jwin[:, :, 1:, 1:]
        )
        # I windows are at static offsets: pch[b,j,r,c] = ipad[r0+b+pad-hw+r, j+pad-hw+c]
        ib = lax.broadcasted_iota(jnp.int32, (pxc.shape[0], w), 0) + (r0 + pad - hw)
        jb = lax.broadcasted_iota(jnp.int32, (pxc.shape[0], w), 1) + (pad - hw)
        rr32 = rr[: _GRID]
        pch = ipch[
            ib[:, :, None, None] + rr32[None, None, :, None],
            jb[:, :, None, None] + rr32[None, None, None, :],
        ]
        # HIGHEST: an f32 contraction that asks for no precision may run in
        # TF32 on GPUs, far outside the oracle's parity budget
        rows.append(jnp.einsum("hwrc,rc->hw", jnp.abs(js - pch), emask,
                               precision=lax.Precision.HIGHEST))
    sad = jnp.concatenate(rows, axis=0)
    return jnp.where(ok, sad / jnp.float32(_GRID * win * win), 0.0)


@partial(jax.jit, static_argnames=("half_window", "n_iter", "asym", "max_shift",
                                   "impl", "calc_err"))
def lk_dense_solve(im1, im2, u0, v0, half_window: int = 13, n_iter: int = 5,
                   asym=(0, 0, 0, 0), max_shift: int = 5, impl: str = "auto",
                   calc_err: bool = False):
    """Dense LK over a full image; returns (u, v, status) — or
    (u, v, status, err) with ``calc_err=True`` (the reference kernel's
    GetError SAD map, computed at pyramid level 0, ref:
    src/denseLucasKanade_PyCL.py:121-123).  ``impl``: "xla"; "auto"
    resolves to it."""
    resolve_impl(impl)
    im1 = im1.astype(jnp.float32)
    im2 = im2.astype(jnp.float32)
    u0 = u0.astype(jnp.float32)
    v0 = v0.astype(jnp.float32)
    h, w = im1.shape
    hw = half_window
    win = 2 * hw + 1
    R = max_shift

    wx = window_mask(win, asym[0], asym[1])
    wy = window_mask(win, asym[2], asym[3])
    runs_x = _runs_from_mask(wx)
    runs_y = _runs_from_mask(wy)

    # Padded domain: window offsets in [-hw, GRID-1-hw], shifts in [-R, R],
    # all taps replicate-clamped.
    pad = hw + (_GRID - hw) + R + 1
    ipad = jnp.pad(im1, pad, mode="edge")
    jpad = jnp.pad(im2, pad, mode="edge")

    g_pair, slab, ia11, ia12, ia22, c1, c2, ok = lk_solve_fields(
        ipad, jpad, hw, R, runs_y, runs_x, h, w
    )
    nshift = 2 * R + 1
    t1s, t2s = lk_build_planes(slab, g_pair, runs_y, runs_x, h, w, R)

    # XLA path: planes laid out shift-minor (H, W, nshift^2) so the
    # per-iteration reduction runs over the minor axis.  The transpose MUST be
    # materialised before the loop — fused into the fori_loop it would
    # re-transpose the whole plane stack every iteration.
    t1, t2 = lax.optimization_barrier(
        (jnp.moveaxis(t1s, 0, -1), jnp.moveaxis(t2s, 0, -1))
    )

    # static per-lane shift coordinates
    s_lin = jax.lax.broadcasted_iota(jnp.float32, (1, 1, nshift * nshift), 2)
    s_y = jnp.floor(s_lin / nshift) - R
    s_x = jnp.mod(s_lin, nshift) - R

    jj = lax.broadcasted_iota(jnp.float32, (h, w), 1)
    ii = lax.broadcasted_iota(jnp.float32, (h, w), 0)

    def gn_body(_, state):
        # track the window origin (prevPt) exactly like the kernel so the
        # f32 bail condition matches bit-for-bit (ref: .cl:505,:517)
        px, py, active, status = state
        oob = (px < -hw) | (px >= w) | (py < -hw) | (py >= h)
        status = jnp.where(active & oob, 0.0, status)
        active = active & ~oob

        u = px + hw - jj
        v = py + hw - ii
        uc = jnp.clip(u, float(-R), R - 1e-3)
        vc = jnp.clip(v, float(-R), R - 1e-3)
        # Bilinear corner blend expressed as a dense tent-weight contraction
        # over the shift lane axis: tent(uc - s_x) * tent(vc - s_y) is exactly
        # (1-fx)/fx x (1-fy)/fy on the 4 enclosing shifts and 0 elsewhere.
        # This trades 8 per-pixel gathers for a fused multiply-reduce over
        # nshift^2 lanes.
        wlane = (
            jnp.maximum(0.0, 1.0 - jnp.abs(uc[..., None] - s_x))
            * jnp.maximum(0.0, 1.0 - jnp.abs(vc[..., None] - s_y))
        )
        s1 = jnp.sum(t1 * wlane, axis=-1)
        s2 = jnp.sum(t2 * wlane, axis=-1)
        b1 = s1 - c1
        b2 = s2 - c2

        dx = (ia12 * b2 - ia22 * b1) * 32.0
        dy = (ia12 * b1 - ia11 * b2) * 32.0

        fa = active.astype(jnp.float32)
        px = px + dx * fa
        py = py + dy * fa
        small = (jnp.abs(dx) < _STEP_EPS) & (jnp.abs(dy) < _STEP_EPS)
        active = active & ~small
        return (px, py, active, status)

    status0 = jnp.ones((h, w), jnp.float32)
    px, py, _, status = lax.fori_loop(
        0, n_iter, gn_body, (jj + u0 - hw, ii + v0 - hw, ok, status0)
    )

    return _lk_finish(im1, ipad, jpad, px, py, status, ok, u0, v0, jj, ii,
                      hw, win, wx, wy, pad, h, w, calc_err)


def _lk_finish(im1, ipad, jpad, px, py, status, ok, u0, v0, jj, ii,
               hw, win, wx, wy, pad, h, w, calc_err):
    u = jnp.where(ok, px + hw - jj, u0)
    v = jnp.where(ok, py + hw - ii, v0)
    status = jnp.where(ok, status, 0.0)
    if not calc_err:
        return u, v, status
    wgt = wy[:, None] * wx[None, :]
    err = _lk_error_map(ipad, jpad, px, py, ok, hw, win, wgt, pad, h, w)
    return u, v, status, err


def evaluate_vorticity_asym(u, v, enable: bool):
    """Vorticity-based asymmetric-window selection
    (ref: src/denseLucasKanade_PyCL.py:75-92).  Host-side decision, like the
    reference's pre-launch configuration."""
    if not enable:
        return (0, 0, 0, 0)
    from opticalflow_ri.ops.stencil import correlate3x3

    d = np.array([[0, -1, 0], [0, 0, 0], [0, 1, 0]], np.float32) * 0.5
    # scipy 'reflect' == our 'symmetric' border
    dv = correlate3x3(jnp.asarray(v, jnp.float32), d.T[::-1, ::-1].copy(), "symmetric")
    du = correlate3x3(jnp.asarray(u, jnp.float32), d[::-1, ::-1].copy(), "symmetric")
    omega = float(jnp.mean(dv - du))
    if omega < -2e-3:
        return (0, 1, 0, 1)
    if omega > 2e-3:
        return (1, 0, 0, 1)
    return (0, 0, 0, 0)


class DenseLucasKanadeAdapter:
    """Driver adapter with the reference host API
    (ref: src/denseLucasKanade_PyCL.py:33-182)."""

    def __init__(self, Niter: int = 5, halfWindow: int = 13,
                 provideGenericPyramidalDefaults: bool = True,
                 enableVorticityEnhancement: bool = False,
                 max_shift: int = 5, computeErrorMap: bool = False):
        self.Niter = int(Niter)
        self.halfWindow = int(halfWindow)
        self.provideGenericPyramidalDefaults = provideGenericPyramidalDefaults
        self.enableVorticityEnhancement = enableVorticityEnhancement
        self.max_shift = int(max_shift)
        # Opt-in: the reference kernel computes its GetError SAD map at level 0
        # but the host discards the buffer (src/denseLucasKanade_PyCL.py:166-169
        # copies it out and never uses it); when enabled here the map is kept
        # on .lastErrorMap instead of widening the adapter-protocol return.
        self.computeErrorMap = bool(computeErrorMap)
        self.lastErrorMap = None

    def compute(self, im1, im2, U, V):
        asym = evaluate_vorticity_asym(U, V, self.enableVorticityEnhancement)
        im1 = jnp.asarray(im1)
        out = lk_dense_solve(
            im1, jnp.asarray(im2), jnp.asarray(U), jnp.asarray(V),
            half_window=self.halfWindow, n_iter=self.Niter, asym=asym,
            max_shift=self.max_shift, calc_err=self.computeErrorMap,
        )
        if self.computeErrorMap:
            self.lastErrorMap = out[3]
        u, v = out[0], out[1]
        # The reference returns its calcErr flag as the "error" (level 0 -> True).
        return u, v, True

    def getAlgoName(self):
        return "Dense LK"

    def hasGenericPyramidalDefaults(self):
        return self.provideGenericPyramidalDefaults

    def getGenericPyramidalDefaults(self):
        return {"warping": False, "intermediateScaling": True, "scaling": False}
