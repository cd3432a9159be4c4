"""Preconditioned conjugate gradients under jit (lax.while_loop).

JAX replacement for deal.II's ``SolverCG`` + ``SolverControl`` as
consumed by the reference driver (reference:
source/geometric_multigrid/program.cc:345-352: absolute tolerance
1e-12 * ||b||, max_iter = vector size).  The loop is fully on-device; the
preconditioner (the multigrid V-cycle) is traced into the loop body.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp


class CGResult(NamedTuple):
    x: jnp.ndarray
    iterations: jnp.ndarray  # int32, deal.II last_step semantics
    residual_norm: jnp.ndarray
    converged: jnp.ndarray  # bool


def _dot(a, b):
    # HIGHEST: an f32 dot at default precision may round its operands (TF32
    # on a GPU), and CG's alpha/beta are where that would cost iterations
    return jnp.vdot(a, b, precision=jax.lax.Precision.HIGHEST)


def cg(
    A: Callable,
    b: jnp.ndarray,
    M: Callable | None = None,
    *,
    rtol: float = 1e-12,
    atol: float = 0.0,
    max_iter: int | None = None,
    x0: jnp.ndarray | None = None,
    dot: Callable | None = None,
) -> CGResult:
    """Solve A x = b with preconditioned CG.

    Stopping: ||r||_2 <= max(rtol * ||b||_2, atol), checked after each update,
    mirroring the reference's SolverControl(size, 1e-12 * rhs.l2_norm())
    (reference: source/geometric_multigrid/program.cc:345-346).

    ``dot`` overrides the inner product — the sharded solver passes a
    duplicate-plane-weighted, psum-reduced dot (parallel/sharding.py), the
    analog of the implicit MPI allreduce in deal.II vector dots (SURVEY.md §5).
    """
    if M is None:
        M = lambda v: v
    if max_iter is None:
        max_iter = b.size
    if dot is None:
        dot = _dot
    norm = lambda v: jnp.sqrt(dot(v, v))
    x = jnp.zeros_like(b) if x0 is None else x0

    r = b - A(x) if x0 is not None else b
    threshold = jnp.maximum(rtol * norm(b), atol)
    res0 = norm(r)

    z = M(r)
    rz = dot(r, z)

    def cond(state):
        x, r, p, rz, it, res = state
        return jnp.logical_and(res > threshold, it < max_iter)

    def body(state):
        x, r, p, rz, it, res = state
        Ap = A(p)
        alpha = rz / dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        res = norm(r)
        z = M(r)
        rz_new = dot(r, z)
        beta = rz_new / rz
        p = z + beta * p
        return (x, r, p, rz_new, it + 1, res)

    state = (x, r, z, rz, jnp.int32(0), res0)
    x, r, p, rz, it, res = jax.lax.while_loop(cond, body, state)
    return CGResult(x=x, iterations=it, residual_norm=res, converged=res <= threshold)


def cg_fixed_iterations(
    A: Callable,
    b: jnp.ndarray,
    M: Callable | None = None,
    *,
    n_iter: int,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Run exactly n_iter CG steps, returning the residual-norm history.

    Used by the test suite to compare residual-reduction histories (the
    convergence ground truth, SURVEY.md §3.2) and by the Lanczos eigenvalue
    estimator in solvers/chebyshev.py.
    """
    if M is None:
        M = lambda v: v
    r = b
    x = jnp.zeros_like(b)
    z = M(r)
    rz = _dot(r, z)

    def step(carry, _):
        x, r, p, rz, stop = carry
        Ap = A(p)
        pAp = _dot(p, Ap)
        alpha = jnp.where(stop, 0.0, rz / jnp.where(pAp == 0, 1.0, pAp))
        x = x + alpha * p
        r = r - alpha * Ap
        res = jnp.linalg.norm(r.ravel())
        z = M(r)
        rz_new = _dot(r, z)
        beta = jnp.where(stop, 0.0, rz_new / jnp.where(rz == 0, 1.0, rz))
        p = z + beta * p
        stop = jnp.logical_or(stop, res == 0.0)
        return (x, r, p, rz_new, stop), res

    init = (x, r, z, rz, jnp.bool_(False))
    (x, *_), history = jax.lax.scan(step, init, None, length=n_iter)
    return x, history
