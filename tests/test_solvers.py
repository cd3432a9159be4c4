"""CG, Chebyshev and V-cycle solver tests: convergence as oracle (SURVEY.md §4)."""

import numpy as np
import jax.numpy as jnp
import pytest

from portable_multigrid_tpu.fem.mesh import HyperCubeMesh
from portable_multigrid_tpu.fem.space import FESpace
from portable_multigrid_tpu.fem.assemble import assemble_rhs, dense_operator
from portable_multigrid_tpu.ops.laplace import make_laplace
from portable_multigrid_tpu.solvers.cg import cg
from portable_multigrid_tpu.solvers.chebyshev import (
    chebyshev_bounds,
    estimate_eigenvalues,
    make_chebyshev,
)
from portable_multigrid_tpu.models.poisson import (
    GeometricMultigridPoisson,
    PolynomialMultigridPoisson,
)


def test_cg_jacobi_solves_poisson():
    sp = FESpace(HyperCubeMesh(2, 3), 2)
    op = make_laplace(sp)
    b = jnp.asarray(assemble_rhs(sp))
    res = cg(op.apply, b, lambda v: op.inv_diag * v, rtol=1e-12)
    assert bool(res.converged)
    # check against dense solve
    A = dense_operator(sp)
    x_dense = np.linalg.solve(A, np.asarray(b).reshape(-1))
    np.testing.assert_allclose(
        np.asarray(res.x).reshape(-1), x_dense, atol=1e-9 * np.abs(x_dense).max()
    )


def test_eigenvalue_estimate_matches_dense():
    sp = FESpace(HyperCubeMesh(2, 2), 2)
    op = make_laplace(sp)
    A = dense_operator(sp)
    D = np.diag(A)
    # dense spectrum of P^-1 A (symmetrized)
    M = A / np.sqrt(D)[:, None] / np.sqrt(D)[None, :]
    ev = np.linalg.eigvalsh(M)
    min_est, max_est = estimate_eigenvalues(
        op, op.inv_diag, n_iter=sp.n_dofs, v0=jnp.asarray(
            np.random.default_rng(0).standard_normal(sp.grid_shape)
            * sp.free_mask()
        )
    )
    # Lanczos with full iterations on the free subspace: extreme eigenvalues
    # of the preconditioned operator restricted to free DoFs.  The dense
    # spectrum includes the constrained identity rows (eigenvalue 1.0).
    assert max_est == pytest.approx(ev[-1], rel=1e-8)
    assert min_est <= ev[-1] and min_est > 0


def test_chebyshev_bounds_rules():
    a, b, d = chebyshev_bounds(0.1, 2.0, 15.0, 5)
    assert b == pytest.approx(2.4)
    assert a == pytest.approx(2.0 / 15.0)  # alpha uses the raw max estimate
    assert d == 5
    a2, b2, d2 = chebyshev_bounds(0.05, 2.0, 1e-3, None)
    assert b2 == pytest.approx(2.4)
    assert a2 == pytest.approx(0.05)
    assert d2 > 5  # adaptive degree for a 1e-3-accurate solver


def test_chebyshev_smoother_reduces_error():
    sp = FESpace(HyperCubeMesh(2, 3), 2)
    op = make_laplace(sp)
    sm = make_chebyshev(op)
    rng = np.random.default_rng(0)
    x_exact = jnp.asarray(rng.standard_normal(sp.grid_shape) * sp.free_mask())
    b = op.apply(x_exact)
    # one smoothing step from zero
    x = sm.apply(b)
    e0 = np.linalg.norm(np.asarray(x_exact))
    e1 = np.linalg.norm(np.asarray(x - x_exact))
    assert e1 < e0  # contracts overall
    # and strongly contracts a high-frequency error component
    k = sp.points_per_axis - 2
    x1 = np.asarray(sp.dof_points_1d())
    hf = np.sin(k * np.pi * x1)[:, None] * np.sin(k * np.pi * x1)[None, :]
    hf = jnp.asarray(hf * sp.free_mask())
    r = op.apply(hf)
    err_hf = np.linalg.norm(np.asarray(sm.apply(r) - hf)) / np.linalg.norm(
        np.asarray(hf)
    )
    assert err_hf < 0.2


def test_chebyshev_as_solver_on_coarse_level():
    """The coarse-level configuration must solve to ~1e-3 accuracy in one
    application (reference: include/multigrid/portable_v_cycle_multigrid.h:148-154)."""
    sp = FESpace(HyperCubeMesh(3, 0), 3)
    op = make_laplace(sp)
    sm = make_chebyshev(
        op, smoothing_range=1e-3, degree=None, eig_cg_n_iterations=sp.n_dofs
    )
    rng = np.random.default_rng(1)
    x_exact = jnp.asarray(rng.standard_normal(sp.grid_shape) * sp.free_mask())
    b = op.apply(x_exact)
    x = sm.apply(b)
    rel = np.linalg.norm(np.asarray(x - x_exact)) / np.linalg.norm(
        np.asarray(x_exact)
    )
    assert rel < 2e-3


@pytest.mark.parametrize("p", [1, 2, 3])
def test_geometric_mg_iteration_counts(p):
    """MG-preconditioned CG converges to 1e-12*||b|| in O(10) iterations,
    mesh-independently — the reference's convergence oracle (reference:
    source/geometric_multigrid/program.cc:345-355)."""
    iters = []
    for r in (2, 3):
        prob = GeometricMultigridPoisson(2, p, r)
        _, st = prob.solve()
        assert st.converged
        iters.append(st.iterations)
    assert max(iters) <= 10
    assert abs(iters[0] - iters[1]) <= 2  # mesh independence


def test_polynomial_mg_converges():
    prob = PolynomialMultigridPoisson(2, 4, 2, 4)
    _, st = prob.solve()
    assert st.converged
    assert st.iterations <= 12


def test_solution_matches_dense_solve():
    sp = FESpace(HyperCubeMesh(2, 3), 2)
    prob = GeometricMultigridPoisson(2, 2, 3)
    x, st = prob.solve()
    A = dense_operator(sp)
    b = assemble_rhs(sp).reshape(-1)
    x_dense = np.linalg.solve(A, b)
    np.testing.assert_allclose(
        np.asarray(x).reshape(-1), x_dense, atol=1e-10 * np.abs(x_dense).max()
    )


def test_l2_norm_regression_3d():
    """Golden-number regression: mesh-converged solution norm for -Δu=1 on
    the unit cube with zero Dirichlet BC."""
    prob = GeometricMultigridPoisson(3, 2, 2)
    _, st = prob.solve()
    assert st.solution_l2_norm == pytest.approx(0.025011634, rel=1e-6)


def test_variable_coefficient_multigrid_solve():
    """Rediscretized-coarse-level MG for a(u,v)=∫c∇u·∇v with smooth c(x):
    O(1) iterations and dense-solve parity."""
    from portable_multigrid_tpu.fem.assemble import dense_operator_coefficient

    def c(*xs):
        out = 1.0
        for x in xs:
            out = out + 0.5 * np.sin(3 * x)
        return out

    prob = GeometricMultigridPoisson(2, 2, 3, coefficient=c)
    x, st = prob.solve()
    assert st.converged and st.iterations <= 10
    sp = FESpace(HyperCubeMesh(2, 3), 2)
    A = dense_operator_coefficient(sp, c)
    b = assemble_rhs(sp).reshape(-1)
    want = np.linalg.solve(A, b)
    np.testing.assert_allclose(
        np.asarray(x).reshape(-1), want, atol=1e-9 * np.abs(want).max()
    )


def test_eig_cap_large_coarse_level_convergence():
    """The Lanczos cap (PMG_EIG_MAX_ITERS=256) governs Chebyshev-as-solver
    coarse levels LARGER than the cap: the 2D Q7 r=4 p-ladder's Q1 coarse
    level has 289 DoFs, so its "eig iterations = m()" request is capped —
    convergence must stay at the mesh-independent 4 iterations with the
    reference solution norm (the uncapped path OOM'd the host tridiagonal
    at production sizes, experiments/r4_batch7.py)."""
    from portable_multigrid_tpu.models.poisson import PolynomialMultigridPoisson

    prob = PolynomialMultigridPoisson(2, 7, 4)
    _, st = prob.solve()
    assert st.converged
    assert st.iterations == 4
    assert st.solution_l2_norm == pytest.approx(0.0412615, rel=1e-5)
