"""Parity against EXECUTABLE ground truth that is not our own oracle.

Two independent sources:

1. The actual reference code at /root/reference/src, imported with a no-op
   numba stub (its @jit kernels are plain NumPy once the decorator is
   stubbed).  This exercises the real ``HornSchunck.py``,
   ``PhysicsBasedOpticalFlowLiuShen.py``, ``gaussian_filter.py`` and
   ``GenericPyramidalOpticalFlow.py`` head-to-head with our engine, so
   driver/solver drift is caught against the reference itself, not the
   oracle package.

2. OpenCV.  The reference's Farneback is an OpenCV OCL port
   (ref: src/Farneback_PyCL.py:15-20) and its dense LK kernel is OpenCV
   pyrLK heritage (ref: src/pyrlkDenseLargeW.cl header) — so
   ``cv2.calcOpticalFlowFarneback`` and a dense grid of
   ``cv2.calcOpticalFlowPyrLK`` points are installable ground truths for
   the two solvers whose OpenCL kernels cannot execute here.
"""

import os
import sys
import types

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")

REF_SRC = "/root/reference/src"


# ---------------------------------------------------------------------------
# Reference-code loading (numba stubbed to no-op)
# ---------------------------------------------------------------------------

def _numba_stub():
    numba = types.ModuleType("numba")

    def _decorator(*args, **kwargs):
        # supports both @jit and @jit(cache=True) forms
        if len(args) == 1 and callable(args[0]) and not kwargs:
            return args[0]
        return lambda fn: fn

    numba.jit = _decorator
    numba.njit = _decorator
    numba.prange = range

    class _ObjMode:
        def __call__(self, *a, **k):
            return self

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    numba.objmode = _ObjMode()
    return numba


@pytest.fixture(scope="module")
def ref():
    """Namespace of real reference modules, or skip when unavailable."""
    if not os.path.isdir(REF_SRC):
        pytest.skip("reference source tree not available")
    os.environ.setdefault("MPLBACKEND", "Agg")
    if "numba" not in sys.modules:
        try:
            import numba  # noqa: F401
        except ImportError:
            sys.modules["numba"] = _numba_stub()
    sys.path.insert(0, REF_SRC)
    try:
        import gaussian_filter as ref_gaussian
        import HornSchunck as ref_hs
        import PhysicsBasedOpticalFlowLiuShen as ref_ls
        import GenericPyramidalOpticalFlow as ref_pyr
    finally:
        sys.path.remove(REF_SRC)
    ns = types.SimpleNamespace(
        gaussian=ref_gaussian, hs=ref_hs, ls=ref_ls, pyr=ref_pyr
    )
    return ns


@pytest.fixture(scope="module")
def crop_pair(reference_images):
    im1, im2 = reference_images
    return (
        np.asarray(im1[:256, :256], np.float32),
        np.asarray(im2[:256, :256], np.float32),
    )


def _aee(u, v, ur, vr):
    return float(np.mean(np.hypot(np.asarray(u) - ur, np.asarray(v) - vr)))


def test_gaussian_filterpx_vs_reference(ref, crop_pair):
    """ref: src/gaussian_filter.py:92-94 (in-place; pass a copy)."""
    from opticalflow_ri.ops.gaussian import gaussian_filter_px

    im1, _ = crop_pair
    expected = ref.gaussian.gaussian_filterPx(im1.copy(), 3.4, 3)
    got = np.asarray(gaussian_filter_px(jnp.asarray(im1), 3.4, 3))
    np.testing.assert_allclose(got, expected, atol=1e-4, rtol=0)


def test_horn_schunck_vs_reference(ref, crop_pair):
    """ref: src/HornSchunck.py:29-105 incl. the im1/im2 role swap."""
    from opticalflow_ri.models.horn_schunck import HSOpticalFlowAlgoAdapter

    im1, im2 = crop_pair
    U0 = np.zeros(im1.shape, np.float32)
    V0 = np.zeros(im1.shape, np.float32)
    eu, ev, _ = ref.hs.HSOpticalFlowAlgoAdapter([21.0], 100).compute(
        im1.copy(), im2.copy(), U0.copy(), V0.copy()
    )
    gu, gv, _ = HSOpticalFlowAlgoAdapter([21.0], 100).compute(
        jnp.asarray(im1), jnp.asarray(im2), jnp.asarray(U0), jnp.asarray(V0)
    )
    assert _aee(gu, gv, eu, ev) < 1e-5


def test_liu_shen_vs_reference(ref, crop_pair):
    """ref: src/PhysicsBasedOpticalFlowLiuShen.py:33-45 (component swap)."""
    from opticalflow_ri.models.liu_shen import LiuShenOpticalFlowAlgoAdapter

    im1, im2 = crop_pair
    U0 = np.zeros(im1.shape, np.float32)
    V0 = np.zeros(im1.shape, np.float32)
    eu, ev, _ = ref.ls.LiuShenOpticalFlowAlgoAdapter(0.1).compute(
        im1.copy(), im2.copy(), U0.copy(), V0.copy()
    )
    gu, gv, _ = LiuShenOpticalFlowAlgoAdapter(0.1).compute(
        jnp.asarray(im1), jnp.asarray(im2), jnp.asarray(U0), jnp.asarray(V0)
    )
    assert _aee(gu, gv, eu, ev) < 1e-6


def test_pyramid_driver_vs_reference(ref, crop_pair):
    """Full 2-level pyramidal HS run through the real reference driver
    (ref: src/GenericPyramidalOpticalFlow.py:238-417)."""
    from opticalflow_ri.models.horn_schunck import HSOpticalFlowAlgoAdapter
    from opticalflow_ri.pyramid import generic_pyramidal_optical_flow

    im1, im2 = crop_pair
    eu, ev = ref.pyr.genericPyramidalOpticalFlow(
        im1.copy(), im2.copy(), 3.4,
        ref.hs.HSOpticalFlowAlgoAdapter([21.0, 45.0], 100),
        pyramidalLevels=2,
    )
    gu, gv = generic_pyramidal_optical_flow(
        jnp.asarray(im1), jnp.asarray(im2), 3.4,
        HSOpticalFlowAlgoAdapter([21.0, 45.0], 100),
        pyramidalLevels=2,
    )
    assert _aee(gu, gv, eu, ev) < 1e-4


def test_liuse_main_vs_reference(ref, crop_pair):
    """The benchmark's Liu-Shen-replaces-main composition through both
    drivers (ref: benchmark_of_methods.py:159-163)."""
    from opticalflow_ri.configs import run_config

    im1, im2 = crop_pair
    eu, ev = ref.pyr.genericPyramidalOpticalFlow(
        im1.copy(), im2.copy(), 2.0,
        ref.ls.LiuShenOpticalFlowAlgoAdapter(0.1),
        pyramidalLevels=2,
    )
    gu, gv = run_config("LiuSE_LK_Fs2_0_PyrLvls2", im1, im2)
    assert _aee(gu, gv, eu, ev) < 1e-4


# ---------------------------------------------------------------------------
# OpenCV ground truth for the OpenCL-heritage solvers
# ---------------------------------------------------------------------------

cv2 = pytest.importorskip("cv2")


@pytest.mark.parametrize("levels", [1, 2])
def test_farneback_vs_opencv(levels, crop_pair):
    """The reference Farneback is an OpenCV OCL port
    (ref: src/Farneback_PyCL.py:15-20); cv2.calcOpticalFlowFarneback is
    therefore executable ground truth. Measured AEE ~0.006 px (float-path
    and resize differences); bound at 0.02."""
    from opticalflow_ri.models.farneback import farneback_solve

    im1, im2 = crop_pair
    z = jnp.zeros(im1.shape, jnp.float32)
    fx, fy = farneback_solve(
        jnp.asarray(im1), jnp.asarray(im2), z, z,
        window_size=33, n_iters=5, poly_n=7, poly_sigma=1.5,
        pyr_levels=levels, impl="xla",
    )
    u8a = np.asarray(np.round(im1), np.uint8)
    u8b = np.asarray(np.round(im2), np.uint8)
    flow = cv2.calcOpticalFlowFarneback(
        u8a, u8b, None, 0.5, levels, 33, 5, 7, 1.5,
        cv2.OPTFLOW_FARNEBACK_GAUSSIAN,
    )
    assert _aee(fx, fy, flow[..., 0], flow[..., 1]) < 0.02


def test_dense_lk_vs_opencv(reference_images):
    """The reference LK kernel is OpenCV pyrLK heritage
    (ref: src/pyrlkDenseLargeW.cl:304-669); a dense grid of sparse pyrLK
    points is ground truth away from borders (the CL variant clamps to edge
    where OpenCV rejects the point). Measured interior AEE ~7e-5; bound at
    1e-3."""
    from opticalflow_ri.models.lucas_kanade import DenseLucasKanadeAdapter

    im1, im2 = reference_images
    c1 = np.asarray(im1[:128, :128], np.float32)
    c2 = np.asarray(im2[:128, :128], np.float32)
    z = jnp.zeros(c1.shape, jnp.float32)
    u, v, _ = DenseLucasKanadeAdapter(Niter=5, halfWindow=13).compute(
        c1, c2, z, z
    )
    u = np.asarray(u)
    v = np.asarray(v)

    H, W = c1.shape
    ys, xs = np.mgrid[0:H, 0:W]
    pts = np.stack([xs.ravel(), ys.ravel()], -1).astype(np.float32)
    pts = pts.reshape(-1, 1, 2)
    crit = (cv2.TERM_CRITERIA_COUNT | cv2.TERM_CRITERIA_EPS, 5, 0.01)
    nxt, status, _ = cv2.calcOpticalFlowPyrLK(
        np.asarray(np.round(c1), np.uint8), np.asarray(np.round(c2), np.uint8),
        pts, pts.copy(), winSize=(27, 27), maxLevel=0, criteria=crit,
        flags=cv2.OPTFLOW_USE_INITIAL_FLOW,
    )
    du = (nxt[:, 0, 0] - pts[:, 0, 0]).reshape(H, W)
    dv = (nxt[:, 0, 1] - pts[:, 0, 1]).reshape(H, W)
    ok = status.reshape(H, W) == 1

    m = 16  # halfWindow + 3: outside the CL clamp-to-edge zone
    sl = np.s_[m:-m, m:-m]
    mask = ok[sl]
    err = np.hypot(u[sl] - du[sl], v[sl] - dv[sl])[mask]
    assert mask.mean() > 0.99
    assert float(err.mean()) < 1e-3
