"""One device policy: every solver's ``impl="auto"`` is its plain XLA body on
every backend, and an impl string that names no implementation raises
instead of falling back."""

import numpy as np
import jax.numpy as jnp
import pytest

from opticalflow_ri.models.farneback import farneback_solve
from opticalflow_ri.models.horn_schunck import hs_solve
from opticalflow_ri.models.liu_shen import liu_shen_solve
from opticalflow_ri.models.lucas_kanade import lk_dense_solve
from opticalflow_ri.ops import resolve_impl


def _pair(shape=(48, 64)):
    from opticalflow_ri.utils.synthetic import particle_image_pair

    a, b, _, _ = particle_image_pair(shape=shape, seed=4)
    z = jnp.zeros(shape, jnp.float32)
    return jnp.asarray(a), jnp.asarray(b), z


SOLVERS = {
    "hs_solve": lambda a, b, z, impl: hs_solve(a, b, 21.0, 20, z, z,
                                               impl=impl),
    "liu_shen_solve": lambda a, b, z, impl: liu_shen_solve(
        a, b, 10.0, z, z, max_iter=5, impl=impl),
    "lk_dense_solve": lambda a, b, z, impl: lk_dense_solve(a, b, z, z,
                                                           impl=impl),
    "farneback_solve": lambda a, b, z, impl: farneback_solve(
        a, b, z, z, n_iters=2, impl=impl),
}


@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_auto_is_the_xla_path(solver):
    a, b, z = _pair()
    got = SOLVERS[solver](a, b, z, "auto")
    want = SOLVERS[solver](a, b, z, "xla")
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("impl", ["pallas", "pallas_tiled", "no_such_impl"])
@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_unknown_impl_raises(solver, impl):
    a, b, z = _pair()
    with pytest.raises(ValueError, match="unknown impl"):
        SOLVERS[solver](a, b, z, impl)


def test_resolve_impl():
    assert resolve_impl("auto") == "xla"
    assert resolve_impl("xla") == "xla"
    with pytest.raises(ValueError):
        resolve_impl("matmul")
