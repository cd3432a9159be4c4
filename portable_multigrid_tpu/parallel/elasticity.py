"""Sharded vector-valued elasticity multigrid (component axis 0, slabs axis 1).

Same slab decomposition as parallel/poisson.py; the vector field adds a
leading component axis, so halos exchange on axis 1 and reductions weight
the duplicated planes across all components.
"""

from __future__ import annotations

import math

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..fem.assemble import assemble_rhs, l2_norm
from ..fem.mesh import HyperCubeMesh
from ..fem.space import FESpace
from ..ops.elasticity import ElasticityOperator, _elasticity_diagonal, \
    make_elasticity
from ..solvers.cg import cg
from ..solvers.chebyshev import Chebyshev, chebyshev_bounds, \
    estimate_eigenvalues, _pseudo_random_grid
from ..solvers.vcycle import MGLevel, VCycle
from .poisson import AXIS, ShardedSolveStats, _build_stacked_h_transfer, \
    _tile, _unstack
from .sharding import (
    ShardedElasticityOperator,
    ShardedTransfer,
    dot_weights_axis0,
    make_sharded_dot,
    partition_axis0,
    unpartition_axis0,
)


def _build_stacked_elasticity(
    space: FESpace, S: int, dtype, mu: float, lam: float
) -> ElasticityOperator:
    b = space.basis
    dim = space.dim
    n = space.mesh.cells_per_axis
    p = space.degree
    qm = np.array(1.0)
    for _ in range(dim):
        qm = np.multiply.outer(qm, b.q_weights)
    qm = qm * space.mesh.h ** (dim - 2)
    mask = space.free_mask()
    diag = _elasticity_diagonal(space, mu, lam)  # [dim, grid]
    # partition the grid axis (axis 1 of diag, axis 0 of mask)
    diag_st = np.stack(
        [
            np.stack([partition_axis0(diag[c], n, p, S)[s] for c in range(dim)])
            for s in range(S)
        ]
    )  # [S, dim, N_loc, N, N]
    return ElasticityOperator(
        dim=dim,
        degree=p,
        n=(n // S,) + (n,) * (dim - 1),
        mu=float(mu),
        lam=float(lam),
        B=_tile(b.B, S, dtype),
        Dco=_tile(b.Dco, S, dtype),
        qmetric=_tile(qm, S, dtype),
        mask=jnp.asarray(partition_axis0(mask, n, p, S), dtype),
        inv_diag=jnp.asarray(1.0 / diag_st, dtype),
    )


class ShardedElasticity:
    """h-multigrid linear elasticity sharded over a 1D device mesh."""

    def __init__(
        self,
        dim: int,
        degree: int,
        refinements: int,
        mu: float = 1.0,
        lam: float = 1.0,
        devices=None,
        dtype=jnp.float64,
    ):
        if devices is None:
            devices = jax.devices()
        self.devices = list(devices)
        S = len(self.devices)
        if S & (S - 1):
            raise ValueError("n_devices must be a power of two")
        self.n_shards = S
        self.dtype = dtype
        self.dim = dim
        self.degree = degree

        min_ref = max(int(math.ceil(math.log2(max(S, 1)))), 0)
        if refinements < min_ref:
            raise ValueError(f"need >= {min_ref} refinements for {S} shards")
        self.spaces = [
            FESpace(HyperCubeMesh(dim, r), degree)
            for r in range(min_ref, refinements + 1)
        ]
        self.mesh = Mesh(np.array(self.devices), (AXIS,))

        levels = []
        for i, sp in enumerate(self.spaces):
            op_st = _build_stacked_elasticity(sp, S, dtype, mu, lam)
            twin = make_elasticity(sp, dtype, mu=mu, lam=lam)
            fm = np.broadcast_to(sp.free_mask()[None], (dim,) + sp.grid_shape)
            v0 = _pseudo_random_grid((dim,) + sp.grid_shape, dtype) * fm
            if i == 0:
                mn, mx = estimate_eigenvalues(
                    twin, twin.inv_diag, min(twin.n_dofs, 128),
                    jnp.asarray(v0, dtype),
                )
                alpha, beta, deg = chebyshev_bounds(mn, mx, 1e-3, None)
            else:
                mn, mx = estimate_eigenvalues(
                    twin, twin.inv_diag, 10, jnp.asarray(v0, dtype)
                )
                alpha, beta, deg = chebyshev_bounds(mn, mx, 15.0, 5)
            smoother = Chebyshev(
                degree=deg,
                op=None,  # wired to the sharded wrapper in shard_map
                inv_diag=op_st.inv_diag,  # stacked assembled diagonal
                theta=_tile(np.full((), (beta + alpha) / 2.0), S, dtype),
                delta=_tile(np.full((), (beta - alpha) / 2.0), S, dtype),
            )
            transfer = (
                _build_stacked_h_transfer(self.spaces[i - 1], sp, S, dtype)
                if i > 0
                else None
            )
            levels.append(MGLevel(op=op_st, smoother=smoother, transfer=transfer))
        self.levels_stacked = tuple(levels)
        fine = self.spaces[-1]
        self.dot_w = jnp.asarray(
            dot_weights_axis0(fine.mesh.cells_per_axis, degree, S), dtype
        )
        self._solve_jit = None

    def _assemble_local(self, levels_stacked):
        S = self.n_shards
        out = []
        for lvl in levels_stacked:
            sop = ShardedElasticityOperator(
                axis_name=AXIS, n_shards=S, local=_unstack(lvl.op)
            )
            sm_st = lvl.smoother
            sm = Chebyshev(
                degree=sm_st.degree,
                op=sop,
                inv_diag=sm_st.inv_diag[0],
                theta=sm_st.theta[0],
                delta=sm_st.delta[0],
            )
            tr = (
                ShardedTransfer(
                    axis_name=AXIS, n_shards=S, halo_axis=1,
                    local=_unstack(lvl.transfer),
                )
                if lvl.transfer is not None
                else None
            )
            out.append(MGLevel(op=sop, smoother=sm, transfer=tr))
        return tuple(out)

    def solve(self, rtol: float = 1e-12, verbose: bool = False):
        fine = self.spaces[-1]
        S = self.n_shards
        dim = self.dim
        n = fine.mesh.cells_per_axis
        rhs_scalar = assemble_rhs(fine)
        parts = partition_axis0(rhs_scalar, n, self.degree, S)
        rhs_st = jnp.asarray(
            np.stack(
                [np.broadcast_to(p_[None], (dim,) + p_.shape) for p_ in parts]
            ),
            self.dtype,
        )

        if self._solve_jit is None:

            def solve_local(levels_stacked, rhs_s, dot_w_s):
                levels = self._assemble_local(levels_stacked)
                rhs = rhs_s[0]
                dot = make_sharded_dot(
                    dot_w_s[0], self.dim, AXIS, lead_axes=1
                )
                mg = VCycle(
                    pre_smoothing_steps=2, post_smoothing_steps=2,
                    levels=levels,
                )
                res = cg(levels[-1].op.apply, rhs, mg.apply, rtol=rtol, dot=dot)
                return res.x[None], res.iterations, res.residual_norm, \
                    res.converged

            self._solve_jit = jax.jit(
                jax.shard_map(
                    solve_local,
                    mesh=self.mesh,
                    in_specs=(P(AXIS), P(AXIS), P(AXIS)),
                    out_specs=(P(AXIS), P(), P(), P()),
                    check_vma=False,
                )
            )
        x_st, iters, resnorm, converged = self._solve_jit(
            self.levels_stacked, rhs_st, self.dot_w
        )
        # unpartition: [S, dim, N_loc, N, N] -> [dim, N, N, N]
        xs = np.asarray(x_st)
        x = np.stack(
            [
                unpartition_axis0(xs[:, c], n, self.degree, S)
                for c in range(dim)
            ]
        )
        norm = float(
            np.sqrt(sum(l2_norm(fine, x[c]) ** 2 for c in range(dim)))
        )
        stats = ShardedSolveStats(
            iterations=int(iters),
            residual_norm=float(resnorm),
            converged=bool(converged),
            solution_l2_norm=norm,
            n_dofs=dim * fine.n_dofs,
            n_shards=S,
            dofs_per_level=[dim * sp.n_dofs for sp in self.spaces],
        )
        if verbose:
            print(
                f" Number of degrees of freedom: {stats.n_dofs} over {S} "
                f"shards"
            )
            print(f"  Solver converged in {stats.iterations} iterations.")
            print(f"  solution norm: {stats.solution_l2_norm:.6g}")
        return x, stats
