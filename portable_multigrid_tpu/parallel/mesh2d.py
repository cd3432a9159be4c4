"""2D device-mesh sharding: pencil decomposition over ('x', 'y').

Scales the domain decomposition beyond 1D slabs: cells are partitioned in
both grid axes over a 2D jax.sharding.Mesh, with single-plane halos on each
sharded axis.  The corner (4-way duplicated) points are handled by ORDERING
the halo exchanges — the y-exchange sends x-completed planes, so diagonal
neighbors' contributions arrive transitively.

Only the pieces that differ from the 1D machinery live here; everything
else (operators, smoothers, V-cycle, CG) is reused unchanged.
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
from ..ops.laplace import LaplaceOperator, diagonal_1d_factors, make_laplace
from ..ops.transfer import Transfer, _weights_1d, make_h_transfer
from ..fem.basis import h_prolongation_matrix_1d
from ..solvers.cg import cg
from ..solvers.chebyshev import Chebyshev, chebyshev_bounds, \
    estimate_eigenvalues, _pseudo_random_grid
from ..solvers.vcycle import MGLevel, VCycle
from ..utils.pytree import pytree_dataclass, static_field
from .poisson import _partial_assembled_1d, _unstack
from .sharding import halo_sum, shard_placement, slab_bounds

AX, AY = "x", "y"


def partition_2d(arr, n: int, p: int, sx: int, sy: int):
    """[N, N, ...] grid -> [sx, sy, N_locx, N_locy, ...] pencil blocks
    (duplicated boundary planes on both sharded axes)."""
    arr = np.asarray(arr)
    bx = slab_bounds(n, p, sx)
    by = slab_bounds(n, p, sy)
    rows = [
        [arr[b0:b1, c0:c1] for (c0, c1) in by] for (b0, b1) in bx
    ]
    return np.stack([np.stack(r) for r in rows])


def unpartition_2d(st, n: int, p: int, sx: int, sy: int):
    st = np.asarray(st)
    cols = []
    for i in range(sx):
        row = [st[i, j][:, :-1] for j in range(sy - 1)] + [st[i, sy - 1]]
        row = np.concatenate(row, axis=1)
        cols.append(row[:-1] if i < sx - 1 else row)
    return np.concatenate(cols, axis=0)


def halo_sum_2d(t: jnp.ndarray, sx: int, sy: int) -> jnp.ndarray:
    """x-exchange first, then y (which transmits the x-completed planes,
    covering the 4-way corner duplication transitively)."""
    t = halo_sum(t, AX, sx, axis=0)
    return halo_sum(t, AY, sy, axis=1)


@pytree_dataclass
class Sharded2DLaplace:
    sx: int = static_field()
    sy: int = static_field()
    local: LaplaceOperator = None

    @property
    def inv_diag(self):
        return self.local.inv_diag

    @property
    def mask(self):
        return self.local.mask

    def apply(self, u: jnp.ndarray) -> jnp.ndarray:
        loc = self.local
        u = u.reshape(loc.grid_shape)
        au = loc.apply_bilinear(u * loc.mask)
        au = halo_sum_2d(au, self.sx, self.sy)
        return loc.mask * au + (1.0 - loc.mask) * u

    vmult = apply


@pytree_dataclass
class Sharded2DTransfer:
    sx: int = static_field()
    sy: int = static_field()
    local: Transfer = None

    def prolongate(self, c):
        return halo_sum_2d(self.local.prolongate(c), self.sx, self.sy)

    def prolongate_and_add(self, dst, c):
        return dst + self.prolongate(c)

    def restrict(self, f):
        return halo_sum_2d(self.local.restrict(f), self.sx, self.sy)

    def restrict_and_add(self, dst, f):
        return dst + self.restrict(f)


def _tile2(arr, sx, sy, dtype):
    a = jnp.asarray(np.asarray(arr), dtype)
    return jnp.broadcast_to(a[None, None], (sx, sy) + a.shape)


def _tile_tree2(tree, sx, sy):
    """Broadcast every leaf of a pytree with two leading mesh axes."""
    return jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a[None, None], (sx, sy) + a.shape), tree
    )


@pytree_dataclass
class Gather2DTransfer:
    """Boundary transfer between a pencil-SHARDED fine level and a REPLICATED
    coarse level on a 2D device mesh (the 2D analog of
    parallel/sharding.py:GatherTransfer; reference coarsening to the base
    mesh: source/geometric_multigrid/program.cc:137-147)."""

    sx: int = static_field()
    sy: int = static_field()
    stride_x: int = static_field()
    nx_pts: int = static_field()
    stride_y: int = static_field()
    ny_pts: int = static_field()
    local: Transfer = None  # full-grid transfer for the level pair

    def _assemble_full(self, f: jnp.ndarray) -> jnp.ndarray:
        gx = jax.lax.all_gather(f, AX)  # [sx, Nx_loc, Ny_loc, ...]
        f = jnp.concatenate(
            [gx[0]] + [gx[s][1:] for s in range(1, self.sx)], axis=0
        )
        gy = jax.lax.all_gather(f, AY)  # [sy, Nx, Ny_loc, ...]
        return jnp.concatenate(
            [gy[0]] + [gy[s][:, 1:] for s in range(1, self.sy)], axis=1
        )

    def restrict(self, f: jnp.ndarray) -> jnp.ndarray:
        return self.local.restrict(self._assemble_full(f))

    def restrict_and_add(self, dst, f):
        return dst + self.restrict(f)

    def prolongate(self, c_full: jnp.ndarray) -> jnp.ndarray:
        ff = self.local.prolongate(c_full)
        ix = jax.lax.axis_index(AX)
        iy = jax.lax.axis_index(AY)
        ff = jax.lax.dynamic_slice_in_dim(
            ff, ix * self.stride_x, self.nx_pts, axis=0
        )
        return jax.lax.dynamic_slice_in_dim(
            ff, iy * self.stride_y, self.ny_pts, axis=1
        )

    def prolongate_and_add(self, dst, c_full):
        return dst + self.prolongate(c_full)


@dataclasses.dataclass
class Sharded2DStats:
    iterations: int
    residual_norm: float
    converged: bool
    solution_l2_norm: float
    n_dofs: int
    mesh_shape: tuple
    # (device, shard shape) of every piece of the sharded solution
    placement: tuple = ()


class Sharded2DGeometricPoisson:
    """3D h-multigrid Poisson over a 2D device mesh (x-y pencils)."""

    def __init__(
        self,
        dim: int,
        degree: int,
        refinements: int,
        mesh_shape: tuple[int, int],
        devices=None,
        dtype=jnp.float64,
        variant: str = "kron",
    ):
        if dim < 2:
            raise ValueError("2D pencil sharding needs dim >= 2")
        if variant not in ("sumfac", "kron"):
            raise ValueError(f"unknown sharded variant: {variant!r}")
        sx, sy = mesh_shape
        if devices is None:
            devices = jax.devices()
        if len(devices) < sx * sy:
            raise ValueError("not enough devices for the mesh shape")
        self.sx, self.sy = sx, sy
        self.dtype = dtype
        self.dim = dim
        self.degree = degree
        min_ref = max(
            int(math.ceil(math.log2(max(sx, 1)))),
            int(math.ceil(math.log2(max(sy, 1)))),
        )
        if refinements < min_ref:
            raise ValueError(f"need >= {min_ref} refinements")
        # replicate levels below shard granularity so the hierarchy reaches
        # the 1-cell base mesh (see parallel/poisson.py)
        self.n_replicated = min_ref
        self.spaces = [
            FESpace(HyperCubeMesh(dim, r), degree)
            for r in range(0, refinements + 1)
        ]
        self.mesh = Mesh(
            np.array(devices[: sx * sy]).reshape(sx, sy), (AX, AY)
        )

        R = self.n_replicated
        levels = []
        for i, sp in enumerate(self.spaces):
            lvl = self._build_level(
                sp, coarse=(i == 0), variant=variant, replicated=(i < R)
            )
            if i == 0:
                transfer = None
            elif i < R:
                transfer = _tile_tree2(
                    make_h_transfer(self.spaces[i - 1], sp, dtype), sx, sy
                )
            elif i == R:
                p = sp.degree
                nlx = sp.mesh.cells_per_axis // sx
                nly = sp.mesh.cells_per_axis // sy
                transfer = Gather2DTransfer(
                    sx=sx, sy=sy,
                    stride_x=nlx * p, nx_pts=nlx * p + 1,
                    stride_y=nly * p, ny_pts=nly * p + 1,
                    local=_tile_tree2(
                        make_h_transfer(self.spaces[i - 1], sp, dtype), sx, sy
                    ),
                )
            else:
                transfer = self._build_transfer(self.spaces[i - 1], sp)
            levels.append(
                MGLevel(op=lvl.op, smoother=lvl.smoother, transfer=transfer)
            )
        self.levels_stacked = tuple(levels)
        fine = self.spaces[-1]
        n = fine.mesh.cells_per_axis
        wx = self._dotw(n, sx)
        wy = self._dotw(n, sy)
        # [sx, sy, N_locx, N_locy]
        self.dot_w = jnp.asarray(
            np.einsum("ia,jb->ijab", wx, wy), dtype
        )
        self._solve_jit = None

    def _dotw(self, n, S):
        from .sharding import dot_weights_axis0

        return dot_weights_axis0(n, self.degree, S)

    def _build_level(
        self, sp: FESpace, coarse: bool, variant: str, replicated: bool = False
    ) -> MGLevel:
        sx, sy = self.sx, self.sy
        dtype = self.dtype
        dim = sp.dim
        p = sp.degree
        n = sp.mesh.cells_per_axis

        if replicated:
            op_plain = make_laplace(sp, dtype, variant=variant)
            v0 = _pseudo_random_grid(sp.grid_shape, dtype) * sp.free_mask()
            n_iter = min(sp.n_dofs, 128) if coarse else 10
            mn, mx = estimate_eigenvalues(
                op_plain, None, n_iter, jnp.asarray(v0, dtype)
            )
            rng = 1e-3 if coarse else 15.0
            alpha, beta, deg = chebyshev_bounds(mn, mx, rng,
                                                None if coarse else 5)
            smoother = Chebyshev(
                degree=deg, op=None, inv_diag=None,
                theta=_tile2(np.full((), (beta + alpha) / 2.0), sx, sy, dtype),
                delta=_tile2(np.full((), (beta - alpha) / 2.0), sx, sy, dtype),
            )
            return MGLevel(op=_tile_tree2(op_plain, sx, sy),
                           smoother=smoother, transfer=None)
        b = sp.basis
        qm = np.array(1.0)
        for _ in range(dim):
            qm = np.multiply.outer(qm, b.q_weights)
        qm = qm * sp.mesh.h ** (dim - 2)
        m1 = sp.free_mask_1d()
        gK, gM = diagonal_1d_factors(sp)
        Kg = Mg = None
        if variant == "kron":
            from ..ops.laplace import assembled_1d_matrices

            K1, M1 = assembled_1d_matrices(sp)
            Kx, Mx = _partial_assembled_1d(sp, n // sx)
            Ky, My = _partial_assembled_1d(sp, n // sy)
            Kg = (
                _tile2(Kx, sx, sy, dtype),
                _tile2(Ky, sx, sy, dtype),
            ) + (_tile2(K1, sx, sy, dtype),) * (dim - 2)
            Mg = (
                _tile2(Mx, sx, sy, dtype),
                _tile2(My, sx, sy, dtype),
            ) + (_tile2(M1, sx, sy, dtype),) * (dim - 2)
        # separable per-axis factors: axis 0 partitioned over sx (broadcast
        # along sy), axis 1 over sy, remaining axes replicated whole
        from .sharding import partition_axis0

        def sep2(v):
            vx = partition_axis0(v, n, p, sx)  # [sx, N_locx]
            vy = partition_axis0(v, n, p, sy)  # [sy, N_locy]
            return (
                jnp.asarray(
                    np.broadcast_to(vx[:, None], (sx, sy) + vx.shape[1:]), dtype
                ),
                jnp.asarray(
                    np.broadcast_to(vy[None], (sx, sy) + vy.shape[1:]), dtype
                ),
            ) + (_tile2(v, sx, sy, dtype),) * (dim - 2)

        op = LaplaceOperator(
            dim=dim,
            degree=p,
            n=(n // sx, n // sy) + (n,) * (dim - 2),
            variant=variant,
            B=_tile2(b.B, sx, sy, dtype),
            Dco=_tile2(b.Dco, sx, sy, dtype),
            qmetric=_tile2(qm, sx, sy, dtype),
            mask1=sep2(m1),
            dK1=sep2(gK),
            dM1=sep2(gM),
            Kg=Kg,
            Mg=Mg,
        )
        twin = make_laplace(sp, dtype)
        v0 = _pseudo_random_grid(sp.grid_shape, dtype) * sp.free_mask()
        if coarse:
            mn, mx = estimate_eigenvalues(
                twin, twin.inv_diag, min(sp.n_dofs, 128), jnp.asarray(v0, dtype)
            )
            alpha, beta, deg = chebyshev_bounds(mn, mx, 1e-3, None)
        else:
            mn, mx = estimate_eigenvalues(
                twin, twin.inv_diag, 10, jnp.asarray(v0, dtype)
            )
            alpha, beta, deg = chebyshev_bounds(mn, mx, 15.0, 5)
        smoother = Chebyshev(
            degree=deg,
            op=None,
            inv_diag=None,  # derived from the operator's 1D factors
            theta=_tile2(np.full((), (beta + alpha) / 2.0), sx, sy, dtype),
            delta=_tile2(np.full((), (beta - alpha) / 2.0), sx, sy, dtype),
        )
        return MGLevel(op=op, smoother=smoother, transfer=None)

    def _build_transfer(self, coarse: FESpace, fine: FESpace) -> Transfer:
        sx, sy = self.sx, self.sy
        dtype = self.dtype
        p = coarse.degree
        dim = coarse.dim
        n_c = coarse.mesh.cells_per_axis
        M1 = h_prolongation_matrix_1d(p)
        wf_full = _weights_1d(n_c, 2 * p) * fine.free_mask_1d()
        mc_full = coarse.free_mask_1d()

        def part1(v, n_cells, S, stride):
            from .sharding import partition_axis0

            return partition_axis0(v, n_cells, stride, S)

        wfx = part1(wf_full, 2 * n_c, sx, p)  # [sx, Nf_loc]
        wfy = part1(wf_full, 2 * n_c, sy, p)
        mcx = part1(mc_full, n_c, sx, p)
        mcy = part1(mc_full, n_c, sy, p)
        # broadcast to [sx, sy, .]
        wmask_f = (
            jnp.asarray(np.broadcast_to(wfx[:, None], (sx, sy) + wfx.shape[1:]), dtype),
            jnp.asarray(np.broadcast_to(wfy[None], (sx, sy) + wfy.shape[1:]), dtype),
        ) + (_tile2(wf_full, sx, sy, dtype),) * (dim - 2)
        mask_c1 = (
            jnp.asarray(np.broadcast_to(mcx[:, None], (sx, sy) + mcx.shape[1:]), dtype),
            jnp.asarray(np.broadcast_to(mcy[None], (sx, sy) + mcy.shape[1:]), dtype),
        ) + (_tile2(mc_full, sx, sy, dtype),) * (dim - 2)
        return Transfer(
            dim=dim,
            n_coarse=(n_c // sx, n_c // sy) + (n_c,) * (dim - 2),
            stride_c=p,
            stride_f=2 * p,
            M1=_tile2(M1, sx, sy, dtype),
            wmask_f=wmask_f,
            mask_c1=mask_c1,
        )

    def _assemble_local(self, levels_stacked):
        R = getattr(self, "n_replicated", 0)
        out = []
        for i, lvl in enumerate(levels_stacked):
            op_loc = _unstack(_unstack(lvl.op))
            if i < R:
                op_w = op_loc  # replicated plain op
            else:
                op_w = Sharded2DLaplace(sx=self.sx, sy=self.sy, local=op_loc)
            sm_st = lvl.smoother
            sm = Chebyshev(
                degree=sm_st.degree,
                op=op_w,
                inv_diag=None,  # op_w.inv_diag from local 1D factors
                theta=sm_st.theta[0, 0],
                delta=sm_st.delta[0, 0],
            )
            if lvl.transfer is None:
                tr = None
            elif i <= R and R > 0:
                # plain replicated transfer (i < R) or Gather2DTransfer (i == R)
                tr = _unstack(_unstack(lvl.transfer))
            else:
                tr = Sharded2DTransfer(
                    sx=self.sx, sy=self.sy,
                    local=_unstack(_unstack(lvl.transfer)),
                )
            out.append(MGLevel(op=op_w, smoother=sm, transfer=tr))
        return tuple(out)

    def solve(self, rtol: float = 1e-12, verbose: bool = False):
        fine = self.spaces[-1]
        sx, sy = self.sx, self.sy
        n = fine.mesh.cells_per_axis
        rhs = assemble_rhs(fine)
        rhs_st = jnp.asarray(
            partition_2d(rhs, n, self.degree, sx, sy), self.dtype
        )

        if self._solve_jit is None:

            def solve_local(levels_stacked, rhs_s, dot_w_s):
                levels = self._assemble_local(levels_stacked)
                rhs_l = rhs_s[0, 0]
                w = dot_w_s[0, 0]
                wfull = w.reshape(w.shape + (1,) * (self.dim - 2))

                def dot(a, b):
                    s = jnp.vdot(a * wfull, b,
                                 precision=jax.lax.Precision.HIGHEST)
                    return jax.lax.psum(jax.lax.psum(s, AX), AY)

                mg = VCycle(
                    pre_smoothing_steps=2, post_smoothing_steps=2,
                    levels=levels,
                )
                res = cg(levels[-1].op.apply, rhs_l, mg.apply, rtol=rtol,
                         dot=dot)
                return (res.x[None, None], res.iterations,
                        res.residual_norm, res.converged)

            self._solve_jit = jax.jit(
                jax.shard_map(
                    solve_local,
                    mesh=self.mesh,
                    in_specs=(P(AX, AY), P(AX, AY), P(AX, AY)),
                    out_specs=(P(AX, AY), P(), P(), P()),
                    check_vma=False,
                )
            )
        x_st, iters, resnorm, conv = self._solve_jit(
            self.levels_stacked, rhs_st, self.dot_w
        )
        x = unpartition_2d(np.asarray(x_st), n, self.degree, sx, sy)
        stats = Sharded2DStats(
            iterations=int(iters),
            residual_norm=float(resnorm),
            converged=bool(conv),
            solution_l2_norm=l2_norm(fine, x),
            n_dofs=fine.n_dofs,
            mesh_shape=(sx, sy),
            placement=shard_placement(x_st),
        )
        if verbose:
            print(
                f" {stats.n_dofs} DoFs over a {sx}x{sy} device mesh; "
                f"converged in {stats.iterations} iterations; "
                f"norm {stats.solution_l2_norm:.6g}"
            )
        return x, stats
