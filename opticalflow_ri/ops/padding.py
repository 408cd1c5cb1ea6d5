"""Border padding modes used across the engine.

The reference mixes four distinct boundary conventions (scipy.ndimage names):
  - "mirror"    : reflect about the edge pixel centre, edge NOT repeated
                  (a b c | b a)          — HS averaging/derivatives
                  (ref: src/HornSchunck.py:66-68,108)
  - "symmetric" : reflect, edge repeated (a b c | c b)
                  — calibrated separable Gaussian (ref: src/gaussian_filter.py:62-78)
  - "nearest"   : replicate edge (a b c | c c)  — Liu-Shen stencils
                  (ref: src/PhysicsBasedOpticalFlowLiuShen.py:124-148)
  - "constant"  : zero pad                       — Liu-Shen H-kernel terms
plus OpenCL's reflect-101 (== "mirror") in the Farneback blur
(ref: src/optical_flow_farneback.cl:135-158) and clamp/replicate (== "nearest")
in the Farneback box filter / polynomial expansion.

All are implemented as explicit pads so the downstream stencil reads become
static slices that XLA fuses into a single elementwise pass.
"""

from __future__ import annotations

import jax.numpy as jnp

_MODES = ("mirror", "symmetric", "nearest", "constant")


def pad2d(x: jnp.ndarray, pad: int | tuple, mode: str) -> jnp.ndarray:
    """Pad the trailing two dims of ``x`` by ``pad`` using a reference border mode.

    ``pad`` may be an int (all sides) or ((top, bottom), (left, right)).
    """
    if isinstance(pad, int):
        pw = ((pad, pad), (pad, pad))
    else:
        pw = pad
    lead = [(0, 0)] * (x.ndim - 2)
    pw_full = tuple(lead) + tuple(tuple(p) for p in pw)
    if mode == "mirror":
        return jnp.pad(x, pw_full, mode="reflect")
    if mode == "symmetric":
        return jnp.pad(x, pw_full, mode="symmetric")
    if mode == "nearest":
        return jnp.pad(x, pw_full, mode="edge")
    if mode == "constant":
        return jnp.pad(x, pw_full, mode="constant")
    raise ValueError(f"unknown border mode {mode!r}; expected one of {_MODES}")
