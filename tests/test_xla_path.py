"""The XLA production path: the ``auto`` operator selector, kron/bkron parity
at their measured crossover, and the precision pin of every f32 contraction
on the production hierarchies (TF32 on a GPU would otherwise leak into
residuals and CG inner products)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.extend import core as jcore

from portable_multigrid_tpu.fem.assemble import dense_operator
from portable_multigrid_tpu.fem.mesh import HyperCubeMesh
from portable_multigrid_tpu.fem.space import FESpace
from portable_multigrid_tpu.models.elasticity import ElasticityMultigrid
from portable_multigrid_tpu.models.mixed import (
    MixedMultigridPoisson,
    MixedPrecisionPoisson,
)
from portable_multigrid_tpu.models.poisson import (
    GeometricMultigridPoisson,
    PolynomialMultigridPoisson,
)
from portable_multigrid_tpu.ops.laplace import best_xla_variant, make_laplace
from portable_multigrid_tpu.solvers.cg import cg
from portable_multigrid_tpu.solvers.vcycle import VCycle

HIGHEST = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)


# ---------------------------------------------------------------------------
# the auto selector
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p", range(1, 8))
@pytest.mark.parametrize("dim,r", [(2, 2), (3, 1)])
def test_auto_operator_matches_dense(dim, r, p):
    """variant="auto" builds best_xla_variant's choice, and that operator is
    the assembled Galerkin matrix (dense oracle) at every degree."""
    sp = FESpace(HyperCubeMesh(dim, r), p)
    op = make_laplace(sp, variant="auto")
    assert op.variant == best_xla_variant(sp)
    A = dense_operator(sp)
    u = np.random.default_rng(p).standard_normal(sp.grid_shape)
    got = np.asarray(op.apply(u)).reshape(-1)
    want = A @ u.reshape(-1)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("dim,p,r", [(1, 1, 4), (2, 7, 8), (3, 4, 6),
                                     (3, 1, 8)])
def test_best_xla_variant_is_the_measured_winner(dim, p, r):
    """dense at every size (host side only: no operator is built)."""
    sp = FESpace(HyperCubeMesh(dim, r), p)
    assert best_xla_variant(sp) == "dense"


def test_auto_with_coefficient_picks_qdense():
    sp = FESpace(HyperCubeMesh(2, 2), 2)
    op = make_laplace(sp, variant="auto", coefficient=lambda x, y: 1.0 + x)
    assert op.variant == "qdense"


# ---------------------------------------------------------------------------
# kron / bkron parity at the crossover
# ---------------------------------------------------------------------------

# Axis point counts N = 2^r p + 1 around the measured kron/bkron crossover
# on an H100 (PERF.md): bkron overtakes kron between N = 769 and 1025 in
# f32 and between 1025 and 1281 in f64.
CROSSOVER = [(1, 3, 8), (1, 1, 10), (1, 5, 8), (2, 3, 8), (2, 1, 10),
             (2, 5, 8)]


@pytest.mark.parametrize("dim,p,r", CROSSOVER)
def test_kron_bkron_parity_at_crossover(dim, p, r):
    sp = FESpace(HyperCubeMesh(dim, r), p)
    u = np.random.default_rng(r).standard_normal(sp.grid_shape)
    ref = np.asarray(make_laplace(sp, variant="kron").apply(u))
    got = np.asarray(make_laplace(sp, variant="bkron").apply(u))
    np.testing.assert_allclose(got, ref, atol=1e-13 * np.abs(ref).max())


# ---------------------------------------------------------------------------
# precision pin of the production f32 hierarchies
# ---------------------------------------------------------------------------

def _hierarchies():
    f32 = jnp.float32
    return {
        "geometric-3d-auto": lambda: GeometricMultigridPoisson(
            3, 2, 2, dtype=f32, variant="auto"),
        "geometric-3d-kron": lambda: GeometricMultigridPoisson(
            3, 2, 1, dtype=f32, variant="kron"),
        "geometric-3d-bkron": lambda: GeometricMultigridPoisson(
            3, 2, 1, dtype=f32, variant="bkron"),
        "geometric-3d-sumfac": lambda: GeometricMultigridPoisson(
            3, 2, 1, dtype=f32, variant="sumfac"),
        "geometric-3d-dense": lambda: GeometricMultigridPoisson(
            3, 2, 1, dtype=f32, variant="dense"),
        "polynomial-2d-auto": lambda: PolynomialMultigridPoisson(
            2, 4, 2, 4, dtype=f32, variant="auto"),
        "mixed-ph-ladder": lambda: MixedMultigridPoisson(
            2, 2, p_ladder=(1, 2), dtype=f32, variant="auto"),
        "mixed-precision": lambda: MixedPrecisionPoisson(
            3, 2, 1, mg_dtype=f32, variant="auto"),
        "elasticity-2d": lambda: ElasticityMultigrid(2, 2, 2, dtype=f32),
    }


def _dots(jaxpr):
    """(precision, operand dtype) of every dot_general, sub-jaxprs included."""
    found = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            found.append((eqn.params["precision"], eqn.invars[0].aval.dtype))
        for v in eqn.params.values():
            for sub in v if isinstance(v, (tuple, list)) else (v,):
                if isinstance(sub, jcore.ClosedJaxpr):
                    found += _dots(sub.jaxpr)
                elif isinstance(sub, jcore.Jaxpr):
                    found += _dots(sub)
    return found


@pytest.mark.parametrize("name", sorted(_hierarchies()))
def test_production_hierarchy_operators_report_highest(name):
    prob = _hierarchies()[name]()
    ops = [lvl.op for lvl in prob.levels]
    if hasattr(prob, "fine_op64"):
        ops.append(prob.fine_op64)
    assert {op.precision for op in ops} == {"highest"}


@pytest.mark.parametrize("name", sorted(_hierarchies()))
def test_every_f32_contraction_of_the_solve_is_highest(name):
    """Trace CG + V-cycle and inspect every dot_general: operator applies,
    smoother, transfers, CG and eig-free inner products alike."""
    prob = _hierarchies()[name]()
    mg = VCycle(levels=prob.levels)
    fine = prob.levels[-1].op
    dtype = jnp.float32
    shape = getattr(fine, "shape", None) or fine.grid_shape
    b = jnp.zeros(shape, dtype)

    def solve(fine, mg, b):
        return cg(fine.apply, b, mg.apply, rtol=1e-5, max_iter=2)

    jaxpr = jax.make_jaxpr(solve)(fine, mg, b).jaxpr
    dots = _dots(jaxpr)
    assert dots, "no contraction traced"
    f32 = [prec for prec, dt in dots if dt == jnp.float32]
    assert f32 and all(prec == HIGHEST for prec in f32), set(map(str, f32))
