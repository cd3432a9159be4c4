"""Vector-valued elasticity operator + solver tests."""

import numpy as np
import pytest

from portable_multigrid_tpu.fem.mesh import HyperCubeMesh
from portable_multigrid_tpu.fem.space import FESpace
from portable_multigrid_tpu.ops.elasticity import (
    dense_elasticity_operator,
    make_elasticity,
)
from portable_multigrid_tpu.models.elasticity import ElasticityMultigrid


CASES = [(2, 1, 2), (2, 2, 2), (3, 2, 1), (3, 3, 1)]


@pytest.mark.parametrize("dim,p,r", CASES)
def test_elasticity_vmult_matches_dense(dim, p, r):
    sp = FESpace(HyperCubeMesh(dim, r), p)
    A = dense_elasticity_operator(sp, mu=0.7, lam=1.3)
    op = make_elasticity(sp, mu=0.7, lam=1.3)
    rng = np.random.default_rng(0)
    u = rng.standard_normal((dim,) + sp.grid_shape)
    got = np.asarray(op.apply(u)).reshape(-1)
    want = A @ u.reshape(-1)
    np.testing.assert_allclose(got, want, atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("dim,p,r", CASES)
def test_elasticity_diagonal_matches_dense(dim, p, r):
    sp = FESpace(HyperCubeMesh(dim, r), p)
    A = dense_elasticity_operator(sp, mu=0.7, lam=1.3)
    op = make_elasticity(sp, mu=0.7, lam=1.3)
    got = (1.0 / np.asarray(op.inv_diag)).reshape(-1)
    np.testing.assert_allclose(got, np.diag(A), rtol=1e-12)


def test_elasticity_symmetry():
    sp = FESpace(HyperCubeMesh(3, 1), 3)
    op = make_elasticity(sp, mu=1.0, lam=2.0)
    rng = np.random.default_rng(1)
    u = rng.standard_normal((3,) + sp.grid_shape)
    v = rng.standard_normal((3,) + sp.grid_shape)
    lhs = np.vdot(np.asarray(op.apply(u)), v)
    rhs = np.vdot(u, np.asarray(op.apply(v)))
    assert lhs == pytest.approx(rhs, rel=1e-13)


def test_elasticity_mg_solve():
    """Q3 elasticity with geometric V-cycle: O(10) iterations, solution
    matches the dense solve."""
    prob = ElasticityMultigrid(2, 3, 2, mu=1.0, lam=1.0)
    x, st = prob.solve()
    assert st.converged
    assert st.iterations <= 12
    sp = prob.spaces[-1]
    A = dense_elasticity_operator(sp, mu=1.0, lam=1.0)
    from portable_multigrid_tpu.fem.assemble import assemble_rhs

    b = np.tile(assemble_rhs(sp).reshape(-1), 2)
    want = np.linalg.solve(A, b)
    np.testing.assert_allclose(
        np.asarray(x).reshape(-1), want, atol=1e-9 * np.abs(want).max()
    )


@pytest.mark.parametrize("dim,p,r", CASES)
def test_elasticity_dense_variant_matches_dense(dim, p, r):
    """The single-matmul element-matrix path (variant="dense") is the
    exact same operator: constant element matrix on the affine mesh,
    overlap-add assembly."""
    sp = FESpace(HyperCubeMesh(dim, r), p)
    A = dense_elasticity_operator(sp, mu=0.7, lam=1.3)
    op = make_elasticity(sp, mu=0.7, lam=1.3, variant="dense")
    rng = np.random.default_rng(0)
    u = rng.standard_normal((dim,) + sp.grid_shape)
    got = np.asarray(op.apply(u)).reshape(-1)
    want = A @ u.reshape(-1)
    np.testing.assert_allclose(got, want, atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("dim,p,r", CASES)
def test_elasticity_kron_matches_dense(dim, p, r):
    """The assembled-1D-matrix (Kronecker) fast path is the exact same
    operator: the elasticity weak form factorizes globally over the
    tensor-product mesh (stiffness/mass/gradient 1D matrices)."""
    sp = FESpace(HyperCubeMesh(dim, r), p)
    A = dense_elasticity_operator(sp, mu=0.7, lam=1.3)
    op = make_elasticity(sp, mu=0.7, lam=1.3, variant="kron")
    rng = np.random.default_rng(0)
    u = rng.standard_normal((dim,) + sp.grid_shape)
    got = np.asarray(op.apply(u)).reshape(-1)
    want = A @ u.reshape(-1)
    np.testing.assert_allclose(got, want, atol=1e-12 * np.abs(want).max())
