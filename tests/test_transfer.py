"""h- and p-transfer tests: dense-embedding parity and exact transposition."""

import numpy as np
import pytest

from portable_multigrid_tpu.fem.mesh import HyperCubeMesh
from portable_multigrid_tpu.fem.space import FESpace
from portable_multigrid_tpu.fem.assemble import dense_prolongation
from portable_multigrid_tpu.ops.transfer import make_h_transfer, make_p_transfer


H_CASES = [(1, 1, 1), (1, 3, 2), (2, 1, 1), (2, 2, 1), (2, 4, 1), (3, 1, 1), (3, 2, 1)]


@pytest.mark.parametrize("dim,p,rc", H_CASES)
def test_h_prolongation_matches_dense(dim, p, rc):
    coarse = FESpace(HyperCubeMesh(dim, rc), p)
    fine = FESpace(HyperCubeMesh(dim, rc + 1), p)
    P = dense_prolongation(coarse, fine)
    tr = make_h_transfer(coarse, fine)
    rng = np.random.default_rng(0)
    c = rng.standard_normal(coarse.grid_shape)
    got = np.asarray(tr.prolongate(c)).reshape(-1)
    want = P @ c.reshape(-1)
    np.testing.assert_allclose(got, want, atol=1e-13 * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("dim,p,rc", H_CASES)
def test_h_restriction_is_transpose(dim, p, rc):
    """<P c, f> == <c, R f> — the reference's restriction kernels are the
    transposes of the prolongation kernels by construction (reference:
    include/multigrid/portable_geometric_transfer.h:390-684)."""
    coarse = FESpace(HyperCubeMesh(dim, rc), p)
    fine = FESpace(HyperCubeMesh(dim, rc + 1), p)
    tr = make_h_transfer(coarse, fine)
    rng = np.random.default_rng(1)
    c = rng.standard_normal(coarse.grid_shape)
    f = rng.standard_normal(fine.grid_shape)
    lhs = np.vdot(np.asarray(tr.prolongate(c)), f)
    rhs = np.vdot(c, np.asarray(tr.restrict(f)))
    assert lhs == pytest.approx(rhs, rel=1e-13)


P_CASES = [(1, 1, 2, 1), (2, 1, 2, 1), (2, 2, 3, 1), (2, 4, 7, 1), (3, 1, 2, 1), (3, 2, 3, 1)]


@pytest.mark.parametrize("dim,pc,pf,r", P_CASES)
def test_p_prolongation_matches_dense(dim, pc, pf, r):
    mesh = HyperCubeMesh(dim, r)
    coarse = FESpace(mesh, pc)
    fine = FESpace(mesh, pf)
    P = dense_prolongation(coarse, fine)
    tr = make_p_transfer(coarse, fine)
    rng = np.random.default_rng(2)
    c = rng.standard_normal(coarse.grid_shape)
    got = np.asarray(tr.prolongate(c)).reshape(-1)
    want = P @ c.reshape(-1)
    np.testing.assert_allclose(got, want, atol=1e-13 * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("dim,pc,pf,r", P_CASES)
def test_p_restriction_is_transpose(dim, pc, pf, r):
    mesh = HyperCubeMesh(dim, r)
    coarse = FESpace(mesh, pc)
    fine = FESpace(mesh, pf)
    tr = make_p_transfer(coarse, fine)
    rng = np.random.default_rng(3)
    c = rng.standard_normal(coarse.grid_shape)
    f = rng.standard_normal(fine.grid_shape)
    lhs = np.vdot(np.asarray(tr.prolongate(c)), f)
    rhs = np.vdot(c, np.asarray(tr.restrict(f)))
    assert lhs == pytest.approx(rhs, rel=1e-13)


def test_prolongation_preserves_interior_polynomials():
    """Prolongating the interpolant of a smooth function that vanishes on the
    boundary reproduces its fine interpolant in the interior (embedding is
    exact on Q_p)."""
    dim, p = 2, 2
    coarse = FESpace(HyperCubeMesh(dim, 2), p)
    fine = FESpace(HyperCubeMesh(dim, 3), p)
    xc = coarse.dof_points_1d()
    xf = fine.dof_points_1d()

    def g(x, y):  # in Q_2, zero on the boundary
        return x * (1 - x) * y * (1 - y)

    C = g(xc[:, None], xc[None, :])
    F = g(xf[:, None], xf[None, :])
    tr = make_h_transfer(coarse, fine)
    got = np.asarray(tr.prolongate(C))
    np.testing.assert_allclose(got, F, atol=1e-13)


def _transfer_pair(kind, p, dtype=None):
    if kind == "h":
        coarse = FESpace(HyperCubeMesh(2, 1), p)
        fine = FESpace(HyperCubeMesh(2, 2), p)
        make = make_h_transfer
    else:
        mesh = HyperCubeMesh(2, 2)
        coarse, fine = FESpace(mesh, p), FESpace(mesh, p + 1)
        make = make_p_transfer
    tr = make(coarse, fine) if dtype is None else make(coarse, fine, dtype)
    return coarse, fine, tr


@pytest.mark.parametrize("p", range(1, 8))
@pytest.mark.parametrize("algo", ["unrolled", "dot"])
@pytest.mark.parametrize("kind", ["h", "p"])
def test_restriction_is_transpose_for_both_algorithms(kind, algo, p):
    """<P c, f> == <c, R f> for both contraction engines at p = 1..7
    (p-transfer: degree p -> p + 1)."""
    import dataclasses

    import jax

    coarse, fine, tr = _transfer_pair(kind, p)
    tr = dataclasses.replace(tr, algo=algo)
    rng = np.random.default_rng(10 + p)
    c = rng.standard_normal(coarse.grid_shape)
    f = rng.standard_normal(fine.grid_shape)
    pc, rf = jax.jit(lambda tr, c, f: (tr.prolongate(c), tr.restrict(f)))(
        tr, c, f)
    lhs = np.vdot(np.asarray(pc), f)
    rhs = np.vdot(c, np.asarray(rf))
    assert lhs == pytest.approx(rhs, rel=1e-13)


@pytest.mark.parametrize("direction", ["restrict", "prolongate"])
def test_f32_dot_transfer_contracts_at_highest(direction):
    """The "dot" engine pins its f32 contractions to HIGHEST precision (an
    f32 tensordot at default precision may run in TF32 on a GPU)."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    coarse, fine, tr = _transfer_pair("h", 3, jnp.float32)
    tr = dataclasses.replace(tr, algo="dot")
    space = fine if direction == "restrict" else coarse
    x = jnp.zeros(space.grid_shape, jnp.float32)
    jaxpr = jax.make_jaxpr(getattr(tr, direction))(x).jaxpr
    precs = [e.params["precision"] for e in jaxpr.eqns
             if e.primitive.name == "dot_general"]
    hi = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)
    assert precs and all(pr == hi for pr in precs)
