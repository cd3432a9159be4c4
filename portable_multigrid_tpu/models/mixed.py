"""Mixed multigrid configurations.

* :class:`MixedMultigridPoisson` — a polynomial ladder on the finest mesh
  (e.g. p = 4 -> 2 -> 1) handing off to geometric coarse levels at p = 1.
  The V-cycle is transfer-agnostic, so this is just a different level list:
  h-levels below, p-levels above.

* :class:`MixedPrecisionPoisson` — the whole V-cycle preconditioner runs in
  a low precision (f32 or bf16) while the outer CG runs in f64.  Mathematically safe — the preconditioner
  need not be exact (SURVEY.md §7 hard part d) — and verified against the
  all-f64 convergence history in the tests.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..fem.assemble import assemble_rhs, l2_norm
from ..fem.mesh import HyperCubeMesh, geometric_coarsening_sequence
from ..fem.space import FESpace
from ..ops.laplace import make_laplace
from ..ops.transfer import make_h_transfer, make_p_transfer
from ..solvers.cg import cg
from ..solvers.vcycle import MGLevel, VCycle
from .poisson import SolveStats, _build_level


class MixedMultigridPoisson:
    """p-ladder on the finest mesh + geometric coarsening below."""

    def __init__(
        self,
        dim: int,
        refinements: int,
        p_ladder: tuple[int, ...] = (1, 2, 4),  # coarse -> fine degrees
        dtype=jnp.float64,
        variant: str = "sumfac",
    ):
        self.dtype = dtype
        mesh = HyperCubeMesh(dim, refinements)
        meshes = geometric_coarsening_sequence(mesh)
        # geometric levels at the lowest degree, then the p-ladder on the
        # finest mesh (excluding its lowest degree, already present)
        spaces = [FESpace(m, p_ladder[0]) for m in meshes]
        spaces += [FESpace(mesh, p) for p in p_ladder[1:]]
        n_h = len(meshes)

        levels = []
        for i, sp in enumerate(spaces):
            op, smoother = _build_level(
                sp, dtype, coarse=(i == 0), variant=variant
            )
            if i == 0:
                transfer = None
            elif i < n_h:
                transfer = make_h_transfer(spaces[i - 1], sp, dtype)
            else:
                transfer = make_p_transfer(spaces[i - 1], sp, dtype)
            levels.append(MGLevel(op=op, smoother=smoother, transfer=transfer))
        self.spaces = spaces
        self.levels = tuple(levels)

    def solve(self, rtol: float = 1e-12, verbose: bool = False):
        fine = self.spaces[-1]
        rhs = jnp.asarray(assemble_rhs(fine), self.dtype)
        mg = VCycle(pre_smoothing_steps=2, post_smoothing_steps=2,
                    levels=self.levels)

        if not hasattr(self, "_run"):
            @partial(jax.jit, static_argnames=("rtol",))
            def run(fine_op, mg, b, rtol):
                return cg(fine_op.apply, b, mg.apply, rtol=rtol)

            self._run = run

        res = self._run(self.levels[-1].op, mg, rhs, rtol)
        x = np.asarray(res.x, dtype=np.float64)
        stats = SolveStats(
            iterations=int(res.iterations),
            residual_norm=float(res.residual_norm),
            converged=bool(res.converged),
            solution_l2_norm=l2_norm(fine, x),
            n_dofs=fine.n_dofs,
            dofs_per_level=[sp.n_dofs for sp in self.spaces],
        )
        if verbose:
            print(f"  Solver converged in {stats.iterations} iterations.")
            print(f"  solution norm: {stats.solution_l2_norm:.6g}")
        return res.x, stats


class MixedPrecisionPoisson:
    """f64 outer CG preconditioned by a low-precision V-cycle."""

    def __init__(
        self,
        dim: int,
        degree: int,
        refinements: int,
        mg_dtype=jnp.float32,
        variant: str = "sumfac",
    ):
        self.mg_dtype = mg_dtype
        mesh = HyperCubeMesh(dim, refinements)
        meshes = geometric_coarsening_sequence(mesh)
        spaces = [FESpace(m, degree) for m in meshes]
        levels = []
        for i, sp in enumerate(spaces):
            op, smoother = _build_level(
                sp, mg_dtype, coarse=(i == 0), variant=variant
            )
            transfer = (
                make_h_transfer(spaces[i - 1], sp, mg_dtype) if i > 0 else None
            )
            levels.append(MGLevel(op=op, smoother=smoother, transfer=transfer))
        self.spaces = spaces
        self.levels = tuple(levels)
        # the outer operator in f64
        self.fine_op64 = make_laplace(spaces[-1], jnp.float64, variant=variant)

    def solve(self, rtol: float = 1e-12, verbose: bool = False):
        fine = self.spaces[-1]
        rhs = jnp.asarray(assemble_rhs(fine), jnp.float64)
        mg = VCycle(pre_smoothing_steps=2, post_smoothing_steps=2,
                    levels=self.levels)
        mg_dtype = self.mg_dtype

        if not hasattr(self, "_run"):
            @partial(jax.jit, static_argnames=("rtol",))
            def run(op64, mg, b, rtol):
                def precond(r):
                    return mg.apply(r.astype(mg_dtype)).astype(jnp.float64)

                return cg(op64.apply, b, precond, rtol=rtol)

            self._run = run

        res = self._run(self.fine_op64, mg, rhs, rtol)
        x = np.asarray(res.x, dtype=np.float64)
        stats = SolveStats(
            iterations=int(res.iterations),
            residual_norm=float(res.residual_norm),
            converged=bool(res.converged),
            solution_l2_norm=l2_norm(fine, x),
            n_dofs=fine.n_dofs,
            dofs_per_level=[sp.n_dofs for sp in self.spaces],
        )
        if verbose:
            print(f"  Solver converged in {stats.iterations} iterations.")
            print(f"  solution norm: {stats.solution_l2_norm:.6g}")
        return res.x, stats
