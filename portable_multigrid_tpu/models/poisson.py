"""Poisson model problems: the two reference drivers, rebuilt in JAX.

  * :class:`GeometricMultigridPoisson` — dim-D Poisson on the unit hyper-cube,
    f ≡ 1, homogeneous Dirichlet on the whole boundary, h-multigrid over the
    geometric coarsening sequence, Chebyshev(5) smoothing, V(2,2), CG to
    1e-12 * ||b|| (reference: source/geometric_multigrid/program.cc).
  * :class:`PolynomialMultigridPoisson` — same PDE on one mesh with a
    polynomial ladder p_l = p - (L-1-l)
    (reference: source/polynomial_multigrid/program.cc:149-159).

Setup (meshes, DoFs, masks, 1D matrices, RHS, eigenvalue estimation) is
host-side; the solve is one jitted function (CG with the V-cycle traced into
the loop body).
"""

from __future__ import annotations

import dataclasses
import os
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..fem.assemble import assemble_rhs, l2_norm
from ..fem.mesh import HyperCubeMesh, geometric_coarsening_sequence
from ..fem.space import FESpace
from ..ops.laplace import make_laplace
from ..ops.transfer import make_h_transfer, make_p_transfer
from ..solvers.cg import CGResult, cg
from ..solvers.chebyshev import make_chebyshev
from ..solvers.vcycle import MGLevel, VCycle


@dataclasses.dataclass
class SolveStats:
    iterations: int
    residual_norm: float
    converged: bool
    solution_l2_norm: float
    n_dofs: int
    dofs_per_level: list


def _build_level(
    space: FESpace,
    dtype,
    coarse: bool,
    variant: str = "sumfac",
    coefficient=None,
) -> MGLevel:
    if coefficient is not None:
        # variable coefficients run the qdense matmul path by default;
        # coarse levels are re-discretizations of the same coefficient
        # (standard geometric MG).  PMG_VARCOEFF_VARIANT opts back into
        # sumfac (the low-memory general path).
        vc = os.environ.get("PMG_VARCOEFF_VARIANT", "qdense")
        op = make_laplace(space, dtype, variant=vc, coefficient=coefficient)
    else:
        op = make_laplace(space, dtype, variant=variant)
    if coarse:
        smoother = make_chebyshev(
            op,
            smoothing_range=1e-3,
            degree=None,
            eig_cg_n_iterations=space.n_dofs,
        )
    else:
        smoother = make_chebyshev(
            op, smoothing_range=15.0, degree=5, eig_cg_n_iterations=10
        )
    return op, smoother


@partial(jax.jit, static_argnames=("rtol",))
def _solve(fine_op, mg: VCycle, rhs, rtol: float) -> CGResult:
    return cg(fine_op.apply, rhs, mg.apply, rtol=rtol)


class _MultigridPoissonBase:
    """Common machinery: build levels, solve, report."""

    def __init__(self, dtype=jnp.float64, variant: str = "sumfac",
                 coefficient=None):
        self.dtype = dtype
        self.variant = variant
        self.coefficient = coefficient
        self.levels: tuple[MGLevel, ...] = ()
        self.spaces: list[FESpace] = []

    def _assemble_levels(self, spaces, make_transfer):
        levels = []
        for i, sp in enumerate(spaces):
            op, smoother = _build_level(
                sp, self.dtype, coarse=(i == 0), variant=self.variant,
                coefficient=self.coefficient,
            )
            transfer = (
                make_transfer(spaces[i - 1], sp, self.dtype) if i > 0 else None
            )
            levels.append(MGLevel(op=op, smoother=smoother, transfer=transfer))
        self.spaces = list(spaces)
        self.levels = tuple(levels)

    def solve(
        self,
        rtol: float = 1e-12,
        pre_smoothing_steps: int = 2,
        post_smoothing_steps: int = 2,
        verbose: bool = False,
        f=None,
    ) -> tuple[jnp.ndarray, SolveStats]:
        """Solve -Δu = f (f ≡ 1 when None, like the reference driver)."""
        fine = self.spaces[-1]
        rhs = jnp.asarray(assemble_rhs(fine, f=f), self.dtype)
        mg = VCycle(
            pre_smoothing_steps=pre_smoothing_steps,
            post_smoothing_steps=post_smoothing_steps,
            levels=self.levels,
        )
        result = _solve(self.levels[-1].op, mg, rhs, rtol)
        x = np.asarray(result.x, dtype=np.float64)
        stats = SolveStats(
            iterations=int(result.iterations),
            residual_norm=float(result.residual_norm),
            converged=bool(result.converged),
            solution_l2_norm=l2_norm(fine, x),
            n_dofs=fine.n_dofs,
            dofs_per_level=[sp.n_dofs for sp in self.spaces],
        )
        if verbose:
            print(
                f" Number of degrees of freedom: {stats.n_dofs} "
                f"(by level: {', '.join(str(d) for d in stats.dofs_per_level)})"
            )
            print(f"  Solver converged in {stats.iterations} iterations.")
            print(f"  solution norm: {stats.solution_l2_norm:.6g}")
        return result.x, stats


class GeometricMultigridPoisson(_MultigridPoissonBase):
    """h-multigrid Poisson solve (reference: source/geometric_multigrid/program.cc).

    ``refinements`` is the finest level; the hierarchy is the full geometric
    coarsening sequence down to the 1-cell base mesh.
    """

    def __init__(
        self,
        dim: int,
        degree: int,
        refinements: int,
        dtype=jnp.float64,
        variant: str = "sumfac",
        coefficient=None,
    ):
        super().__init__(dtype, variant, coefficient)
        mesh = HyperCubeMesh(dim, refinements)
        meshes = geometric_coarsening_sequence(mesh)
        spaces = [FESpace(m, degree) for m in meshes]
        self._assemble_levels(spaces, make_h_transfer)


class PolynomialMultigridPoisson(_MultigridPoissonBase):
    """p-multigrid Poisson solve (reference: source/polynomial_multigrid/program.cc).

    One mesh; degrees p_l = degree - (n_levels-1-l)
    (reference: source/polynomial_multigrid/program.cc:149-159).
    """

    def __init__(
        self,
        dim: int,
        degree: int,
        refinements: int,
        n_levels: int | None = None,
        dtype=jnp.float64,
        variant: str = "sumfac",
    ):
        super().__init__(dtype, variant)
        if n_levels is None:
            n_levels = degree
        if n_levels > degree:
            raise ValueError("n_levels must be <= degree")
        mesh = HyperCubeMesh(dim, refinements)
        degrees = [degree - (n_levels - 1 - l) for l in range(n_levels)]
        spaces = [FESpace(mesh, p) for p in degrees]
        self._assemble_levels(spaces, make_p_transfer)
