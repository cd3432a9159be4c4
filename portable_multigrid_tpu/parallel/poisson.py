"""Sharded multigrid Poisson solver over a jax.sharding.Mesh.

The multi-chip counterpart of models/poisson.py: the full solve (CG +
V-cycle + smoothers + transfers + operator) runs inside ONE ``jax.shard_map``
region over a 1D device mesh, with cell slabs sharded along grid axis 0 and
single-plane halos exchanged via ppermute (parallel/sharding.py).  This is
the analog of running the reference drivers under ``mpirun -n N``
with deal.II's distributed triangulation (reference:
source/geometric_multigrid/program.cc:73-75,124-132,452).

Level layout: levels with at least one cell slab per shard are sharded;
levels BELOW the shard granularity are REPLICATED on every chip
(deterministic identical compute, entered through a gather-to-replicated
transfer, ``sharding.GatherTransfer``), so the hierarchy reaches the 1-cell
base mesh exactly like the reference
(source/geometric_multigrid/program.cc:137-147) and sharded iteration
counts match the single-device solver EXACTLY
(tests/test_sharding.py::test_sharded_counts_match_single_device).

Smoother eigenvalue bounds are estimated at setup on a single-device twin of
each level operator — the sharded operator is mathematically identical, so
the bounds transfer exactly.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..fem.assemble import assemble_rhs, l2_norm
from ..fem.mesh import HyperCubeMesh
from ..fem.space import FESpace
from ..ops.laplace import (
    LaplaceOperator,
    assembled_1d_matrices,
    diagonal_1d_factors,
    make_laplace,
)
from ..ops.transfer import Transfer, _weights_1d
from ..fem.basis import h_prolongation_matrix_1d, p_prolongation_matrix_1d
from ..solvers.cg import cg
from ..solvers.chebyshev import Chebyshev, chebyshev_bounds, estimate_eigenvalues, \
    _pseudo_random_grid
from ..solvers.vcycle import MGLevel, VCycle
from ..ops.transfer import make_h_transfer
from .sharding import (
    GatherTransfer,
    ShardedLaplaceOperator,
    ShardedTransfer,
    dot_weights_axis0,
    estimate_eigenvalues_sharded,
    make_sharded_dot,
    partition_axis0,
    shard_placement,
    unpartition_axis0,
)

AXIS = "x"


def _tile(arr, S, dtype):
    a = jnp.asarray(np.asarray(arr), dtype)
    return jnp.broadcast_to(a[None], (S,) + a.shape)


def _partial_assembled_1d(space: FESpace, n_cells: int):
    """PARTIAL 1D assembly over n_cells cells (local slab matrices; boundary
    rows carry only the slab's own contributions, completed by halo_sum —
    slicing the global assembly would double-count shared-plane diagonals)."""
    b = space.basis
    p = space.degree
    W = np.diag(b.q_weights)
    Kc = (b.D.T @ W @ b.D) / space.mesh.h
    Mc = (b.B.T @ W @ b.B) * space.mesh.h
    w = n_cells * p + 1
    K = np.zeros((w, w))
    M = np.zeros((w, w))
    for c in range(n_cells):
        sl = slice(c * p, c * p + p + 1)
        K[sl, sl] += Kc
        M[sl, sl] += Mc
    return K, M


def _build_stacked_operator(
    space: FESpace, S: int, dtype, variant: str = "sumfac", precision="highest"
) -> LaplaceOperator:
    """LaplaceOperator pytree whose leaves carry a leading shard axis."""
    b = space.basis
    dim = space.dim
    n = space.mesh.cells_per_axis
    p = space.degree
    qm = np.array(1.0)
    for _ in range(dim):
        qm = np.multiply.outer(qm, b.q_weights)
    qm = qm * space.mesh.h ** (dim - 2)
    m1 = space.free_mask_1d()
    gK, gM = diagonal_1d_factors(space)
    Kg = Mg = None
    if variant == "kron":
        K1, M1 = assembled_1d_matrices(space)
        K0, M0 = _partial_assembled_1d(space, n // S)
        Kg = (_tile(K0, S, dtype),) + (_tile(K1, S, dtype),) * (dim - 1)
        Mg = (_tile(M0, S, dtype),) + (_tile(M1, S, dtype),) * (dim - 1)
    # separable mask/diagonal factors: the axis-0 factor is the GLOBAL 1D
    # vector sliced to the slab (duplicated planes carry the global values,
    # so the lazily formed mask/inv_diag match the single-device operator on
    # every shard); remaining axes replicate the global factors.
    def sep(v):
        return (jnp.asarray(partition_axis0(v, n, p, S), dtype),) + (
            _tile(v, S, dtype),
        ) * (dim - 1)

    return LaplaceOperator(
        dim=dim,
        degree=p,
        n=(n // S,) + (n,) * (dim - 1),
        variant=variant,
        precision=precision,
        B=_tile(b.B, S, dtype),
        Dco=_tile(b.Dco, S, dtype),
        qmetric=_tile(qm, S, dtype),
        mask1=sep(m1),
        dK1=sep(gK),
        dM1=sep(gM),
        Kg=Kg,
        Mg=Mg,
    )


def _build_stacked_h_transfer(
    coarse: FESpace, fine: FESpace, S: int, dtype
) -> Transfer:
    p = coarse.degree
    n_c = coarse.mesh.cells_per_axis
    dim = coarse.dim
    M1 = h_prolongation_matrix_1d(p)
    wf_full = _weights_1d(n_c, 2 * p) * fine.free_mask_1d()
    mc_full = coarse.free_mask_1d()
    wf0 = partition_axis0(wf_full, 2 * n_c, p, S)  # fine grid axis 0 slabs
    mc0 = partition_axis0(mc_full, n_c, p, S)
    wmask_f = (jnp.asarray(wf0, dtype),) + (_tile(wf_full, S, dtype),) * (dim - 1)
    mask_c1 = (jnp.asarray(mc0, dtype),) + (_tile(mc_full, S, dtype),) * (dim - 1)
    return Transfer(
        dim=dim,
        n_coarse=(n_c // S,) + (n_c,) * (dim - 1),
        stride_c=p,
        stride_f=2 * p,
        M1=_tile(M1, S, dtype),
        wmask_f=wmask_f,
        mask_c1=mask_c1,
    )


def _build_stacked_p_transfer(
    coarse: FESpace, fine: FESpace, S: int, dtype
) -> Transfer:
    """Stacked polynomial transfer (same mesh, degrees p_c < p_f)."""
    n = coarse.mesh.cells_per_axis
    dim = coarse.dim
    pc, pf = coarse.degree, fine.degree
    M1 = p_prolongation_matrix_1d(pc, pf)
    wf_full = _weights_1d(n, pf) * fine.free_mask_1d()
    mc_full = coarse.free_mask_1d()
    wf0 = partition_axis0(wf_full, n, pf, S)
    mc0 = partition_axis0(mc_full, n, pc, S)
    wmask_f = (jnp.asarray(wf0, dtype),) + (_tile(wf_full, S, dtype),) * (dim - 1)
    mask_c1 = (jnp.asarray(mc0, dtype),) + (_tile(mc_full, S, dtype),) * (dim - 1)
    return Transfer(
        dim=dim,
        n_coarse=(n // S,) + (n,) * (dim - 1),
        stride_c=pc,
        stride_f=pf,
        M1=_tile(M1, S, dtype),
        wmask_f=wmask_f,
        mask_c1=mask_c1,
    )


def _unstack(tree):
    """Drop the leading (sharded, now size-1) axis from every leaf."""
    return jax.tree_util.tree_map(lambda a: a[0], tree)


def _tile_tree(tree, S):
    """Broadcast every leaf of a pytree with a leading shard axis."""
    return jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a[None], (S,) + a.shape), tree
    )


@dataclasses.dataclass
class ShardedSolveStats:
    iterations: int
    residual_norm: float
    converged: bool
    solution_l2_norm: float
    n_dofs: int
    n_shards: int
    dofs_per_level: list
    # (device, shard shape) of every piece of the sharded solution
    placement: tuple = ()


class ShardedGeometricPoisson:
    """h-multigrid Poisson solve sharded over a 1D device mesh."""

    def __init__(
        self,
        dim: int,
        degree: int,
        refinements: int,
        devices=None,
        dtype=jnp.float64,
        variant: str = "sumfac",
        sharded_setup: bool = False,
        replicate_coarse: bool = True,
    ):
        if devices is None:
            devices = jax.devices()
        self.devices = list(devices)
        S = len(self.devices)
        if S & (S - 1):
            raise ValueError("n_devices must be a power of two")
        if variant not in ("sumfac", "kron"):
            raise ValueError(f"unknown sharded variant: {variant!r}")
        self.n_shards = S
        self.dtype = dtype
        self.dim = dim
        self.degree = degree
        self.variant = variant
        self.sharded_setup = sharded_setup

        min_ref = max(int(math.ceil(math.log2(max(S, 1)))), 0)
        if refinements < min_ref:
            raise ValueError(
                f"need >= {min_ref} refinements to give every one of {S} shards a cell slab"
            )
        # levels below the shard granularity (fewer cell slabs than chips)
        # are REPLICATED on every chip, so the hierarchy reaches the 1-cell
        # base mesh exactly like the reference
        # (source/geometric_multigrid/program.cc:137-147) and iteration
        # counts match the single-device solver exactly.
        self.n_replicated = min_ref if replicate_coarse else 0
        self.spaces = [
            FESpace(HyperCubeMesh(dim, r), degree)
            for r in range(min_ref - self.n_replicated, refinements + 1)
        ]
        self.mesh = Mesh(np.array(self.devices), (AXIS,))
        self._build_levels(_build_stacked_h_transfer)

    def _build_levels(self, transfer_builder):
        S = self.n_shards
        dtype = self.dtype
        # stacked level pytrees + eigenvalue bounds (sharded CG-Lanczos when
        # requested — no single-device twin needed at scale — else twins)
        levels = []
        variant = getattr(self, "variant", "sumfac")
        sharded_setup = getattr(self, "sharded_setup", False)
        R = getattr(self, "n_replicated", 0)
        for i, sp in enumerate(self.spaces):
            replicated = i < R
            # coarse level: reference-faithful m() = n_dofs eig-CG iterations
            # (source/geometric_multigrid/program.cc:274-279); the coarse
            # space is the replicated 1-cell base mesh, so this stays tiny
            n_iter = sp.n_dofs if i == 0 else 10
            rng_v = _pseudo_random_grid(sp.grid_shape, dtype) * sp.free_mask()
            if replicated:
                # below shard granularity: a plain full-grid operator,
                # identical on every device (deterministic replicated compute)
                op_plain = make_laplace(sp, dtype, variant=variant)
                op_stacked = _tile_tree(op_plain, S)
                mn, mx = estimate_eigenvalues(
                    op_plain, None, n_iter, jnp.asarray(rng_v, dtype)
                )
            else:
                op_stacked = _build_stacked_operator(
                    sp, S, dtype, variant=variant
                )
                if sharded_setup:
                    n = sp.mesh.cells_per_axis
                    v0_st = jnp.asarray(
                        partition_axis0(rng_v, n, sp.degree, S), dtype
                    )
                    w_st = jnp.asarray(
                        dot_weights_axis0(n, sp.degree, S), dtype
                    )
                    mn, mx = estimate_eigenvalues_sharded(
                        op_stacked, self.mesh, AXIS, S, w_st, self.dim,
                        n_iter, v0_st,
                    )
                else:
                    twin = make_laplace(sp, dtype)
                    mn, mx = estimate_eigenvalues(
                        twin, None, n_iter, jnp.asarray(rng_v, dtype)
                    )
            if i == 0:
                alpha, beta, deg = chebyshev_bounds(mn, mx, 1e-3, None)
            else:
                alpha, beta, deg = chebyshev_bounds(mn, mx, 15.0, 5)
            smoother = Chebyshev(
                degree=deg,
                op=None,  # wired to the (sharded/replicated) op in shard_map
                inv_diag=None,  # derived from the operator's 1D factors
                theta=_tile(np.full((), (beta + alpha) / 2.0), S, dtype),
                delta=_tile(np.full((), (beta - alpha) / 2.0), S, dtype),
            )
            if i == 0:
                transfer = None
            elif i < R:
                # replicated pair: plain full-grid transfer on every chip
                transfer = _tile_tree(
                    make_h_transfer(self.spaces[i - 1], sp, dtype), S
                )
            elif i == R and R > 0:
                # boundary pair: replicated coarse <-> first sharded level
                p = sp.degree
                n_loc = sp.mesh.cells_per_axis // S
                transfer = GatherTransfer(
                    axis_name=AXIS,
                    n_shards=S,
                    slab_stride=n_loc * p,
                    n_loc_points=n_loc * p + 1,
                    local=_tile_tree(
                        make_h_transfer(self.spaces[i - 1], sp, dtype), S
                    ),
                )
            else:
                transfer = transfer_builder(self.spaces[i - 1], sp, S, dtype)
            levels.append(MGLevel(op=op_stacked, smoother=smoother, transfer=transfer))
        self.levels_stacked = tuple(levels)

        fine = self.spaces[-1]
        self.degree = fine.degree
        self.dim = fine.dim
        self.dot_w = jnp.asarray(
            dot_weights_axis0(fine.mesh.cells_per_axis, fine.degree, S), dtype
        )
        self._solve_jit = None

    # ------------------------------------------------------------------
    def _assemble_local(self, levels_stacked):
        """Inside shard_map: strip the shard axis and wire sharded wrappers.

        Levels below ``n_replicated`` run as plain full-grid operators and
        transfers (replicated on every chip); the boundary level uses
        GatherTransfer; everything above is halo-exchange sharded."""
        S = self.n_shards
        R = getattr(self, "n_replicated", 0)
        out = []
        for i, lvl in enumerate(levels_stacked):
            op_loc = _unstack(lvl.op)
            if i < R:
                op_w = op_loc  # replicated plain op
            else:
                op_w = ShardedLaplaceOperator(
                    axis_name=AXIS, n_shards=S, local=op_loc
                )
            sm_st = lvl.smoother
            sm = Chebyshev(
                degree=sm_st.degree,
                op=op_w,
                inv_diag=None,  # op_w.inv_diag from local 1D factors
                theta=sm_st.theta[0],
                delta=sm_st.delta[0],
            )
            if lvl.transfer is None:
                tr = None
            elif i <= R and R > 0:
                # plain replicated transfer (i < R) or GatherTransfer (i == R)
                tr = _unstack(lvl.transfer)
            else:
                tr = ShardedTransfer(
                    axis_name=AXIS, n_shards=S, local=_unstack(lvl.transfer)
                )
            out.append(MGLevel(op=op_w, smoother=sm, transfer=tr))
        return tuple(out)

    def _make_solve(self, rtol: float, pre: int, post: int):
        def solve_local(levels_stacked, rhs_st, dot_w_st):
            levels = self._assemble_local(levels_stacked)
            rhs = rhs_st[0]
            dot = make_sharded_dot(dot_w_st[0], self.dim, AXIS)
            mg = VCycle(
                pre_smoothing_steps=pre, post_smoothing_steps=post, levels=levels
            )
            res = cg(levels[-1].op.apply, rhs, mg.apply, rtol=rtol, dot=dot)
            return res.x[None], res.iterations, res.residual_norm, res.converged

        sharded = jax.shard_map(
            solve_local,
            mesh=self.mesh,
            in_specs=(P(AXIS), P(AXIS), P(AXIS)),
            out_specs=(P(AXIS), P(), P(), P()),
            check_vma=False,
        )
        return jax.jit(sharded)

    def solve(
        self,
        rtol: float = 1e-12,
        pre_smoothing_steps: int = 2,
        post_smoothing_steps: int = 2,
        verbose: bool = False,
    ):
        fine = self.spaces[-1]
        S = self.n_shards
        rhs = assemble_rhs(fine)
        rhs_st = jnp.asarray(
            partition_axis0(rhs, fine.mesh.cells_per_axis, self.degree, S),
            self.dtype,
        )
        if self._solve_jit is None:
            self._solve_jit = self._make_solve(
                rtol, pre_smoothing_steps, post_smoothing_steps
            )
        x_st, iters, resnorm, converged = self._solve_jit(
            self.levels_stacked, rhs_st, self.dot_w
        )
        x = unpartition_axis0(
            np.asarray(x_st), fine.mesh.cells_per_axis, self.degree, S
        )
        stats = ShardedSolveStats(
            iterations=int(iters),
            residual_norm=float(resnorm),
            converged=bool(converged),
            solution_l2_norm=l2_norm(fine, x),
            n_dofs=fine.n_dofs,
            n_shards=S,
            dofs_per_level=[sp.n_dofs for sp in self.spaces],
            placement=shard_placement(x_st),
        )
        if verbose:
            print(
                f" Number of degrees of freedom: {stats.n_dofs} over {S} shards "
                f"(by level: {', '.join(str(d) for d in stats.dofs_per_level)})"
            )
            print(f"  Solver converged in {stats.iterations} iterations.")
            print(f"  solution norm: {stats.solution_l2_norm:.6g}")
        return x, stats


class ShardedPolynomialPoisson(ShardedGeometricPoisson):
    """p-multigrid Poisson solve sharded over a 1D device mesh.

    One mesh, degree ladder p_l = degree - (n_levels-1-l) (reference:
    source/polynomial_multigrid/program.cc:149-159); every level sharded
    into the same cell slabs.
    """

    def __init__(
        self,
        dim: int,
        degree: int,
        refinements: int,
        n_levels: int | None = None,
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

        if n_levels is None:
            n_levels = degree
        if n_levels > degree:
            raise ValueError("n_levels must be <= degree")
        mesh = HyperCubeMesh(dim, refinements)
        if mesh.cells_per_axis % S:
            raise ValueError(
                f"cells per axis ({mesh.cells_per_axis}) must be divisible "
                f"by n_devices ({S})"
            )
        degrees = [degree - (n_levels - 1 - l) for l in range(n_levels)]
        self.spaces = [FESpace(mesh, p) for p in degrees]
        self.mesh = Mesh(np.array(self.devices), (AXIS,))
        self._build_levels(_build_stacked_p_transfer)
