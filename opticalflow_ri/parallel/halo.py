"""ppermute halo exchange for spatially-sharded stencils.

Inside a ``shard_map`` over mesh axes ('y', 'x'), every stencil iteration
needs an apron of neighbour rows/columns.  ``exchange_halo`` pads a local tile
with real neighbour data moved between devices via ``lax.ppermute``; tiles on the
global border synthesise their apron from the solver's boundary rule instead
(mirror / symmetric / nearest / constant — the four reference border modes,
see ops/padding.py).

This is the sharded replacement for the reference's whole-image borders:
per-tile padding alone would change the numerics (SURVEY.md hard part #4 —
global mirror != per-tile mirror), so interior tile edges always carry real
neighbour data.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def _boundary_block(x, n, side, axis, mode):
    """Apron of width ``n`` on ``side`` ('lo'/'hi') of ``axis`` per border rule."""
    size = x.shape[axis]
    idx = [slice(None)] * x.ndim
    if mode == "mirror":
        idx[axis] = slice(1, n + 1) if side == "lo" else slice(size - n - 1, size - 1)
        blk = x[tuple(idx)]
        return jnp.flip(blk, axis=axis)
    if mode == "symmetric":
        idx[axis] = slice(0, n) if side == "lo" else slice(size - n, size)
        blk = x[tuple(idx)]
        return jnp.flip(blk, axis=axis)
    if mode == "nearest":
        idx[axis] = slice(0, 1) if side == "lo" else slice(size - 1, size)
        blk = x[tuple(idx)]
        reps = [1] * x.ndim
        reps[axis] = n
        return jnp.tile(blk, reps)
    if mode == "constant":
        shp = list(x.shape)
        shp[axis] = n
        return jnp.zeros(shp, x.dtype)
    raise ValueError(f"unknown boundary mode {mode!r}")


def _exchange_axis(x, lo, hi, mesh_axis, axis, mode):
    """Pad ``axis`` of the local tile with (lo, hi) halo widths along mesh
    axis ``mesh_axis``."""
    if lo == 0 and hi == 0:
        return x
    p = lax.axis_size(mesh_axis)
    me = lax.axis_index(mesh_axis)

    parts = []
    if lo > 0:
        idx = [slice(None)] * x.ndim
        idx[axis] = slice(x.shape[axis] - lo, x.shape[axis])
        send = x[tuple(idx)]  # my bottom rows -> become lower neighbour's top apron
        recv = lax.ppermute(send, mesh_axis, [(i, i + 1) for i in range(p - 1)])
        top = jnp.where(me == 0, _boundary_block(x, lo, "lo", axis, mode), recv)
        parts.append(top)
    parts.append(x)
    if hi > 0:
        idx = [slice(None)] * x.ndim
        idx[axis] = slice(0, hi)
        send = x[tuple(idx)]  # my top rows -> upper neighbour's bottom apron
        recv = lax.ppermute(send, mesh_axis, [(i, i - 1) for i in range(1, p)])
        bot = jnp.where(me == p - 1, _boundary_block(x, hi, "hi", axis, mode), recv)
        parts.append(bot)
    return jnp.concatenate(parts, axis=axis)


def exchange_halo(x, halo, mode, axis_y: str = "y", axis_x: str = "x"):
    """Pad the trailing two dims of local tile ``x`` with neighbour halos.

    ``halo`` is an int (all four sides) or ((top, bottom), (left, right)).
    Must be called inside ``shard_map`` with mesh axes ``axis_y``/``axis_x``.
    Halo widths must not exceed the local tile extent.
    """
    if isinstance(halo, int):
        (t, b), (l, r) = (halo, halo), (halo, halo)
    else:
        (t, b), (l, r) = halo
    out = _exchange_axis(x, t, b, axis_y, x.ndim - 2, mode)
    out = _exchange_axis(out, l, r, axis_x, x.ndim - 1, mode)
    return out
