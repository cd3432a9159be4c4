"""Matrix-free Laplace operator vs dense golden assembly (SURVEY.md §4)."""

import numpy as np
import pytest

from portable_multigrid_tpu.fem.mesh import HyperCubeMesh
from portable_multigrid_tpu.fem.space import FESpace
from portable_multigrid_tpu.fem.assemble import dense_operator
from portable_multigrid_tpu.ops.laplace import make_laplace


CASES = [
    (1, 1, 3),
    (1, 4, 2),
    (2, 1, 2),
    (2, 2, 2),
    (2, 5, 1),
    (3, 1, 1),
    (3, 2, 1),
    (3, 3, 1),
    (3, 4, 1),
]


@pytest.mark.parametrize("dim,p,r", CASES)
def test_vmult_matches_dense(dim, p, r):
    sp = FESpace(HyperCubeMesh(dim, r), p)
    A = dense_operator(sp)
    op = make_laplace(sp)
    rng = np.random.default_rng(1)
    u = rng.standard_normal(sp.grid_shape)
    got = np.asarray(op.apply(u)).reshape(-1)
    want = A @ u.reshape(-1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("dim,p,r", CASES)
def test_diagonal_matches_dense(dim, p, r):
    sp = FESpace(HyperCubeMesh(dim, r), p)
    A = dense_operator(sp)
    op = make_laplace(sp)
    got = np.asarray(op.diagonal()).reshape(-1)
    np.testing.assert_allclose(got, np.diag(A), rtol=1e-13)


@pytest.mark.parametrize("dim,p,r", [(2, 3, 2), (3, 2, 1)])
def test_operator_symmetry(dim, p, r):
    sp = FESpace(HyperCubeMesh(dim, r), p)
    op = make_laplace(sp)
    rng = np.random.default_rng(2)
    u = rng.standard_normal(sp.grid_shape)
    v = rng.standard_normal(sp.grid_shape)
    lhs = np.vdot(np.asarray(op.apply(u)), v)
    rhs = np.vdot(u, np.asarray(op.apply(v)))
    assert lhs == pytest.approx(rhs, rel=1e-13)


@pytest.mark.parametrize("dim,p,r", [(2, 2, 2), (3, 3, 1)])
def test_constrained_rows_identity(dim, p, r):
    """Constrained (Dirichlet) DoFs: dst = src (copy_constrained_values,
    reference: include/operators/portable_laplace_operator.h:718)."""
    sp = FESpace(HyperCubeMesh(dim, r), p)
    op = make_laplace(sp)
    rng = np.random.default_rng(3)
    u = rng.standard_normal(sp.grid_shape)
    au = np.asarray(op.apply(u))
    m = sp.free_mask()
    np.testing.assert_allclose(au[m == 0], u[m == 0], atol=0)


def test_nullspace_of_constant_on_interior():
    """A applied to the constant-1 vector on an unconstrained... structured
    check: for the interior of a large mesh, A @ 1 has zero entries at DoFs
    whose full stencil is interior (the Laplacian of a constant)."""
    sp = FESpace(HyperCubeMesh(2, 3), 2)
    op = make_laplace(sp)
    u = np.ones(sp.grid_shape)
    au = np.asarray(op.apply(u))
    # DoFs at least one full cell away from the boundary see only the
    # constant: rows sum to zero there.
    p = sp.degree
    inner = au[2 * p : -2 * p, 2 * p : -2 * p]
    np.testing.assert_allclose(inner, 0.0, atol=1e-12)


@pytest.mark.parametrize("dim,p,r", [(1, 3, 2), (2, 2, 2), (3, 2, 1), (3, 4, 1)])
def test_variants_agree(dim, p, r):
    """All operator variants (sumfac / dense element matrix / assembled
    Kronecker) implement the same matrix."""
    sp = FESpace(HyperCubeMesh(dim, r), p)
    rng = np.random.default_rng(7)
    u = rng.standard_normal(sp.grid_shape)
    ref = np.asarray(make_laplace(sp, variant="sumfac").apply(u))
    scale = np.abs(ref).max()
    for variant in ("dense", "kron", "bkron"):
        got = np.asarray(make_laplace(sp, variant=variant).apply(u))
        np.testing.assert_allclose(got, ref, atol=1e-13 * scale)


@pytest.mark.parametrize("dim,p,r", [(1, 5, 6), (2, 7, 5), (2, 3, 6)])
def test_bkron_large_n_matches_kron(dim, p, r):
    """The block-tridiagonal Kronecker repack is exact at axis sizes that
    straddle multiple 128-blocks and need end padding (N = 321, 225, 193) —
    the regime the 2D drivers run it in."""
    sp = FESpace(HyperCubeMesh(dim, r), p)
    rng = np.random.default_rng(11)
    u = rng.standard_normal(sp.grid_shape)
    ref = np.asarray(make_laplace(sp, variant="kron").apply(u))
    got = np.asarray(make_laplace(sp, variant="bkron").apply(u))
    np.testing.assert_allclose(got, ref, atol=1e-13 * np.abs(ref).max())


def test_bkron_solve_count_parity():
    """A 2D p-ladder solve on bkron levels must reproduce the sumfac
    iteration count and norm — the end-to-end guard for the block-banded
    operator + smoother interplay."""
    from portable_multigrid_tpu.models.poisson import (
        PolynomialMultigridPoisson,
    )

    _, a = PolynomialMultigridPoisson(2, 4, 3, 4, variant="bkron").solve()
    _, s = PolynomialMultigridPoisson(2, 4, 3, 4, variant="sumfac").solve()
    assert a.converged and a.iterations == s.iterations
    assert a.solution_l2_norm == pytest.approx(s.solution_l2_norm, rel=1e-10)


def _coef(*xs):
    out = 1.0
    for x in xs:
        out = out + 0.3 * np.sin(3 * x)
    return out


@pytest.mark.parametrize("dim,p,r", [(1, 3, 2), (2, 2, 2), (3, 2, 1)])
@pytest.mark.parametrize("variant", ["sumfac", "qdense", "qbanded"])
def test_variable_coefficient_matches_dense(dim, p, r, variant):
    """a(u,v) = ∫ c grad u . grad v with a smooth c(x)."""
    from portable_multigrid_tpu.fem.assemble import dense_operator_coefficient

    sp = FESpace(HyperCubeMesh(dim, r), p)
    A = dense_operator_coefficient(sp, _coef)
    op = make_laplace(sp, coefficient=_coef, variant=variant)
    rng = np.random.default_rng(5)
    u = rng.standard_normal(sp.grid_shape)
    got = np.asarray(op.apply(u)).reshape(-1)
    want = A @ u.reshape(-1)
    np.testing.assert_allclose(got, want, atol=1e-12 * np.abs(want).max())
    np.testing.assert_allclose(
        (1.0 / np.asarray(op.inv_diag)).reshape(-1), np.diag(A), rtol=1e-12
    )


@pytest.mark.parametrize("dim,p,r", [(3, 4, 2), (2, 7, 3)])
def test_qdense_matches_sumfac(dim, p, r):
    """qdense (two-matmul form) == sumfac q-point loop to roundoff at
    the degrees the dense oracle can't reach."""
    sp = FESpace(HyperCubeMesh(dim, r), p)
    rng = np.random.default_rng(11)
    u = rng.standard_normal(sp.grid_shape)
    ref = np.asarray(
        make_laplace(sp, coefficient=_coef, variant="sumfac").apply(u)
    )
    got = np.asarray(
        make_laplace(sp, coefficient=_coef, variant="qdense").apply(u)
    )
    np.testing.assert_allclose(got, ref, atol=1e-13 * np.abs(ref).max())
