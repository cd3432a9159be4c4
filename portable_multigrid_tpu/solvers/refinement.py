"""Mixed-precision iterative refinement: f64 accuracy from f32 inner solves.

Where f64 arithmetic is slow or unavailable, the reference's 1e-12
relative-residual target (reference:
source/geometric_multigrid/program.cc:345-346) is reached by
classical iterative refinement (Wilkinson; Carson & Higham 2018):

    x = 0;  r = b                                [f64]
    repeat: d = InnerSolve(r) to ~1e-7           [f32 CG + V-cycle]
            x += d;  r = b - A x                 [f64 operator apply]
    until ||r|| <= rtol ||b||

Each refinement cycle multiplies the residual by ~the inner tolerance, so
two to three f32 inner solves reach 1e-12; only ~one f64 operator apply per
cycle is emulated.  Verified in the tests to match the all-f64 solve.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp


def iterative_refinement(
    A64: Callable,
    inner_solve32: Callable,
    b: jnp.ndarray,
    *,
    rtol: float = 1e-12,
    max_cycles: int = 8,
):
    """Solve A x = b to f64 accuracy using an f32 inner solver.

    A64: f64 operator apply; inner_solve32: f32_array -> f32_array
    (approximate solve, e.g. CG+V-cycle to ~1e-7).  Returns
    (x, cycles, residual_norm).
    """
    b = b.astype(jnp.float64)
    bnorm = jnp.linalg.norm(b.ravel())
    threshold = rtol * bnorm

    def cond(state):
        x, r, res, it = state
        return jnp.logical_and(res > threshold, it < max_cycles)

    def body(state):
        x, r, res, it = state
        d = inner_solve32(r.astype(jnp.float32)).astype(jnp.float64)
        x = x + d
        r = b - A64(x)
        return (x, r, jnp.linalg.norm(r.ravel()), it + 1)

    x0 = jnp.zeros_like(b)
    state = (x0, b, bnorm, jnp.int32(0))
    x, r, res, it = jax.lax.while_loop(cond, body, state)
    return x, it, res
