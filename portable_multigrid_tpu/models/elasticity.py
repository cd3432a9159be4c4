"""Linear elasticity model problem: geometric multigrid, vector Q_p elements.

Vector-valued driver: -div sigma(u) = f on the unit hyper-cube with
homogeneous Dirichlet everywhere, f = (1, ..., 1), solved by CG with a
geometric V-cycle preconditioner (same algorithmic skeleton as the Poisson
driver — the operator and vectors are just vector-valued)."""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..fem.assemble import assemble_rhs, l2_norm
from ..fem.mesh import HyperCubeMesh, geometric_coarsening_sequence
from ..fem.space import FESpace
from ..ops.elasticity import make_elasticity
from ..ops.transfer import make_h_transfer
from ..solvers.cg import cg
from ..solvers.chebyshev import make_chebyshev
from ..solvers.vcycle import MGLevel, VCycle
from .poisson import SolveStats


class ElasticityMultigrid:
    """h-multigrid elasticity solve on the unit hyper-cube."""

    def __init__(
        self,
        dim: int,
        degree: int,
        refinements: int,
        mu: float = 1.0,
        lam: float = 1.0,
        dtype=jnp.float64,
        variant: str = "kron",
    ):
        self.dtype = dtype
        mesh = HyperCubeMesh(dim, refinements)
        self.spaces = [
            FESpace(m, degree) for m in geometric_coarsening_sequence(mesh)
        ]
        # kron (assembled 1D matrices applied as large matmuls) is exact to
        # roundoff and the default; every contraction at "highest" precision
        levels = []
        for i, sp in enumerate(self.spaces):
            op = make_elasticity(sp, dtype, mu=mu, lam=lam, variant=variant)
            if i == 0:
                sm = make_chebyshev(
                    op,
                    smoothing_range=1e-3,
                    degree=None,
                    eig_cg_n_iterations=op.n_dofs,
                    free_mask=np.broadcast_to(
                        sp.free_mask()[None], (dim,) + sp.grid_shape
                    ),
                )
            else:
                sm = make_chebyshev(
                    op,
                    smoothing_range=15.0,
                    degree=5,
                    eig_cg_n_iterations=10,
                    free_mask=np.broadcast_to(
                        sp.free_mask()[None], (dim,) + sp.grid_shape
                    ),
                )
            tr = (
                make_h_transfer(self.spaces[i - 1], sp, dtype) if i > 0 else None
            )
            levels.append(MGLevel(op=op, smoother=sm, transfer=tr))
        self.levels = tuple(levels)

    def solve(self, rtol: float = 1e-12, verbose: bool = False):
        fine = self.spaces[-1]
        dim = fine.dim
        rhs_scalar = assemble_rhs(fine)  # f = 1 per component
        rhs = jnp.asarray(
            np.broadcast_to(rhs_scalar[None], (dim,) + fine.grid_shape),
            self.dtype,
        )
        mg = VCycle(pre_smoothing_steps=2, post_smoothing_steps=2,
                    levels=self.levels)

        if not hasattr(self, "_run"):
            @partial(jax.jit, static_argnames=("rtol",))
            def run(fine_op, mg, b, rtol):
                return cg(fine_op.apply, b, mg.apply, rtol=rtol)

            self._run = run

        res = self._run(self.levels[-1].op, mg, rhs, rtol)
        x = np.asarray(res.x, dtype=np.float64)
        norm = float(
            np.sqrt(sum(l2_norm(fine, x[c]) ** 2 for c in range(dim)))
        )
        stats = SolveStats(
            iterations=int(res.iterations),
            residual_norm=float(res.residual_norm),
            converged=bool(res.converged),
            solution_l2_norm=norm,
            n_dofs=dim * fine.n_dofs,
            dofs_per_level=[dim * sp.n_dofs for sp in self.spaces],
        )
        if verbose:
            print(
                f" Number of degrees of freedom: {stats.n_dofs} "
                f"(by level: {', '.join(str(d) for d in stats.dofs_per_level)})"
            )
            print(f"  Solver converged in {stats.iterations} iterations.")
            print(f"  solution norm: {stats.solution_l2_norm:.6g}")
        return res.x, stats
