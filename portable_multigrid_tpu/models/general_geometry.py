"""Geometric multigrid on general (non-affine) geometry.

The reference supports arbitrary deal.II meshes through MappingQ-dependent
geometry tables even though its drivers only run cubes; this model provides
the same capability end-to-end: indexed operators with per-quadrature-point
Jacobians (ops/indexed.py) on a hierarchy of nested-topology meshes, with
rediscretized coarse operators.

Key observation: grid-transfer operators act on REFERENCE-cell DoFs and are
geometry-independent (deal.II's global-coarsening transfers likewise), so
the structured h-transfer applies unchanged; only the operators carry the
curved geometry.  The mesh hierarchy subsamples the fine vertex grid (every
2^k-th vertex), which is exactly a coarsening of the same deformed domain.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..fem.general_mesh import GeneralMesh
from ..fem.mesh import HyperCubeMesh
from ..fem.space import FESpace
from ..ops.indexed import make_indexed_laplace
from ..ops.transfer import make_h_transfer
from ..solvers.cg import cg
from ..solvers.chebyshev import make_chebyshev
from ..solvers.vcycle import MGLevel, VCycle
from .poisson import SolveStats


from ..utils.pytree import pytree_dataclass, static_field


@pytree_dataclass
class FlatTransfer:
    """Grid transfer adapted to flat (indexed-path) vectors."""

    coarse_shape: tuple = static_field()
    fine_shape: tuple = static_field()
    inner: object = None

    def prolongate(self, c):
        return self.inner.prolongate(c.reshape(self.coarse_shape)).reshape(-1)

    def prolongate_and_add(self, dst, c):
        return dst + self.prolongate(c)

    def restrict(self, f):
        return self.inner.restrict(f.reshape(self.fine_shape)).reshape(-1)

    def restrict_and_add(self, dst, f):
        return dst + self.restrict(f)


def coarsen_vertex_grid(gmesh: GeneralMesh, dim: int, n_fine: int) -> GeneralMesh:
    """Subsample a structured-topology vertex grid by 2 in every direction."""
    from ..fem.general_mesh import structured_as_general

    V = n_fine + 1
    verts = gmesh.vertices.reshape((V,) * dim + (dim,))
    sl = (slice(None, None, 2),) * dim
    coarse_verts = verts[sl].reshape(-1, dim)
    n_c = n_fine // 2
    import math

    topo = structured_as_general(HyperCubeMesh(dim, int(math.log2(n_c))))
    return GeneralMesh(vertices=coarse_verts, cells=topo.cells)


class UnstructuredMultigrid:
    """h-multigrid Poisson on a FULLY unstructured hex/quad mesh hierarchy.

    Closes the gap between the unstructured operator path (native
    orientation-matched DoF enumeration + indexed kernels) and multigrid:
    the hierarchy comes from uniform refinement of an arbitrary coarse mesh
    (fem/general_mesh.py:refine_general_mesh — nested multilinear geometry),
    and transfers are per-cell embedding contractions
    (ops/indexed.py:IndexedTransfer).  The unstructured analog of the
    reference's geometric driver (source/geometric_multigrid/program.cc),
    which deal.II would support on such meshes through the same machinery.
    """

    def __init__(
        self,
        gmesh_coarse: GeneralMesh,
        degree: int,
        n_refinements: int,
        dtype=jnp.float64,
    ):
        from ..fem.general_mesh import refine_general_mesh
        from ..native import enumerate_dofs
        from ..ops.indexed import (
            make_unstructured_h_transfer,
            make_unstructured_laplace,
        )

        self.dtype = dtype
        self.degree = degree
        meshes = [gmesh_coarse]
        for _ in range(n_refinements):
            meshes.append(refine_general_mesh(meshes[-1]))
        self.meshes = meshes
        self.dof_packs = [enumerate_dofs(m, degree) for m in meshes]

        levels = []
        for i, (gm, pack) in enumerate(zip(meshes, self.dof_packs)):
            op = make_unstructured_laplace(gm, degree, dtype, dofs=pack)
            if i == 0:
                sm = make_chebyshev(
                    op, smoothing_range=1e-3, degree=None,
                    eig_cg_n_iterations=pack[0], free_mask=pack[2],
                )
            else:
                sm = make_chebyshev(
                    op, smoothing_range=15.0, degree=5,
                    eig_cg_n_iterations=10, free_mask=pack[2],
                )
            tr = (
                make_unstructured_h_transfer(
                    meshes[i - 1], degree,
                    self.dof_packs[i - 1], pack, dtype,
                )
                if i
                else None
            )
            levels.append(MGLevel(op=op, smoother=sm, transfer=tr))
        self.levels = tuple(levels)

    def output_vtu(self, filename: str, u) -> None:
        """Write the solution on the unstructured fine mesh to a .vtu file
        (vertex-sampled, the DataOut analog)."""
        from ..utils.vtu import vertex_values, write_vtu

        gm = self.meshes[-1]
        _, l2g, _ = self.dof_packs[-1]
        write_vtu(
            filename, gm,
            {"solution": vertex_values(gm, self.degree, l2g, np.asarray(u))},
        )

    def solve(self, f=None, rtol: float = 1e-12, verbose: bool = False):
        """Solve -Δu = f (f ≡ 1 when None, like the reference driver)."""
        from ..fem.assemble import assemble_rhs_indexed

        gm = self.meshes[-1]
        n_dofs, l2g, mask = self.dof_packs[-1]
        if f is None:
            f = lambda *c: np.ones_like(c[0])  # noqa: E731
        rhs = assemble_rhs_indexed(gm, l2g, self.degree, n_dofs, mask, f)
        rhs = jnp.asarray(rhs, self.dtype)

        @jax.jit
        def run(fine_op, mg, b):
            return cg(fine_op.apply, b, mg.apply, rtol=rtol)

        mg = VCycle(pre_smoothing_steps=2, post_smoothing_steps=2,
                    levels=self.levels)
        res = run(self.levels[-1].op, mg, rhs)
        stats = SolveStats(
            iterations=int(res.iterations),
            residual_norm=float(res.residual_norm),
            converged=bool(res.converged),
            solution_l2_norm=float(np.linalg.norm(np.asarray(res.x))),
            n_dofs=n_dofs,
            dofs_per_level=[p[0] for p in self.dof_packs],
        )
        if verbose:
            print(
                f" {stats.n_dofs} unstructured DoFs (by level: "
                f"{', '.join(str(d) for d in stats.dofs_per_level)})"
            )
            print(f"  Solver converged in {stats.iterations} iterations.")
        return res.x, stats


class GeneralGeometryMultigrid:
    """h-multigrid Poisson on a deformed (structured-topology) mesh."""

    def __init__(
        self,
        gmesh: GeneralMesh,
        degree: int,
        refinements: int,
        dtype=jnp.float64,
    ):
        """gmesh: deformed mesh with structured topology and 2^refinements
        cells per axis (e.g. from fem.general_mesh.perturbed_cube_mesh)."""
        self.dtype = dtype
        dim = gmesh.dim
        n = 1 << refinements

        meshes = [gmesh]
        for r in range(refinements, 0, -1):
            meshes.append(coarsen_vertex_grid(meshes[-1], dim, 1 << r))
        meshes = meshes[::-1]  # coarsest first
        self.spaces = [
            FESpace(HyperCubeMesh(dim, r), degree)
            for r in range(refinements + 1)
        ]
        self.gmeshes = meshes

        levels = []
        for i, (sp, gm) in enumerate(zip(self.spaces, meshes)):
            op = make_indexed_laplace(sp, gm, dtype)
            if i == 0:
                sm = make_chebyshev(
                    op,
                    smoothing_range=1e-3,
                    degree=None,
                    eig_cg_n_iterations=sp.n_dofs,
                    free_mask=sp.free_mask().reshape(-1),
                )
            else:
                sm = make_chebyshev(
                    op, smoothing_range=15.0, degree=5,
                    eig_cg_n_iterations=10,
                    free_mask=sp.free_mask().reshape(-1),
                )
            tr = make_h_transfer(self.spaces[i - 1], sp, dtype) if i else None
            levels.append(MGLevel(op=op, smoother=sm, transfer=tr))
        self.levels = tuple(levels)

    def output_vtu(self, filename: str, u) -> None:
        """Write the solution on the deformed fine mesh to a .vtu file."""
        from ..utils.vtu import vertex_values, write_vtu

        sp = self.spaces[-1]
        write_vtu(
            filename, self.gmeshes[-1],
            {"solution": vertex_values(
                self.gmeshes[-1], sp.degree, sp.local_to_global(),
                np.asarray(u))},
        )

    def solve(self, rhs: np.ndarray | None = None, rtol: float = 1e-12,
              verbose: bool = False):
        """rhs defaults to a masked random vector (no general-geometry host
        quadrature for f; pass your own assembled rhs for a specific f)."""
        fine_sp = self.spaces[-1]
        if rhs is None:
            rng = np.random.default_rng(0)
            rhs = rng.standard_normal(fine_sp.n_dofs) * (
                fine_sp.free_mask().reshape(-1)
            )
        rhs = jnp.asarray(np.asarray(rhs).reshape(-1), self.dtype)

        # indexed operators act on flat vectors; transfers act on grids —
        # wrap transfers with reshapes (pytree, so everything jits cleanly)
        glevels = tuple(
            MGLevel(
                op=lvl.op,
                smoother=lvl.smoother,
                transfer=(
                    FlatTransfer(
                        coarse_shape=self.spaces[i - 1].grid_shape,
                        fine_shape=self.spaces[i].grid_shape,
                        inner=lvl.transfer,
                    )
                    if lvl.transfer is not None
                    else None
                ),
            )
            for i, lvl in enumerate(self.levels)
        )

        @jax.jit
        def run(fine_op, mg, b):
            return cg(fine_op.apply, b, mg.apply, rtol=rtol)

        mg = VCycle(pre_smoothing_steps=2, post_smoothing_steps=2,
                    levels=glevels)
        res = run(self.levels[-1].op, mg, rhs)
        stats = SolveStats(
            iterations=int(res.iterations),
            residual_norm=float(res.residual_norm),
            converged=bool(res.converged),
            solution_l2_norm=float(np.linalg.norm(np.asarray(res.x))),
            n_dofs=fine_sp.n_dofs,
            dofs_per_level=[sp.n_dofs for sp in self.spaces],
        )
        if verbose:
            print(f"  Solver converged in {stats.iterations} iterations.")
        return res.x, stats


class CurvedMultigrid:
    """h-multigrid Poisson on a genuinely CURVED domain: every level's
    operator carries the Q_q (MappingQ-analog) geometry evaluated from the
    same smooth transform — the counterpart of the reference
    building MappingQ(fe_degree) per level (reference:
    include/operators/portable_laplace_operator.h:469-482).

    Levels are structured in REFERENCE space (transfers act on reference
    DoFs, geometry-independent); each level's control points sample the
    transform at its own cells' Gauss-Lobatto nodes, so coarse levels are
    the Q_q interpolant of the same manifold — standard isoparametric
    geometric multigrid.  ``mapping_degree`` defaults to the FE degree
    (isoparametric, like the reference's MappingQ(fe_degree)).
    """

    def __init__(
        self,
        dim: int,
        degree: int,
        refinements: int,
        transform,
        mapping_degree: int | None = None,
        dtype=jnp.float64,
    ):
        from ..fem.general_mesh import curved_structured_geometry

        self.dtype = dtype
        self.transform = transform
        q = degree if mapping_degree is None else mapping_degree
        self.mapping_degree = q
        self.spaces = [
            FESpace(HyperCubeMesh(dim, r), degree)
            for r in range(refinements + 1)
        ]
        self.geos = [
            curved_structured_geometry(dim, sp.mesh.cells_per_axis,
                                       transform, q)
            for sp in self.spaces
        ]
        levels = []
        for i, (sp, geo) in enumerate(zip(self.spaces, self.geos)):
            op = make_indexed_laplace(sp, geo, dtype)
            if i == 0:
                sm = make_chebyshev(
                    op, smoothing_range=1e-3, degree=None,
                    eig_cg_n_iterations=sp.n_dofs,
                    free_mask=sp.free_mask().reshape(-1),
                )
            else:
                sm = make_chebyshev(
                    op, smoothing_range=15.0, degree=5,
                    eig_cg_n_iterations=10,
                    free_mask=sp.free_mask().reshape(-1),
                )
            tr = make_h_transfer(self.spaces[i - 1], sp, dtype) if i else None
            levels.append(MGLevel(op=op, smoother=sm, transfer=tr))
        self.levels = tuple(levels)

    def solve(self, f, rtol: float = 1e-12, verbose: bool = False):
        """Solve -Δu = f on the curved domain with V(2,2)-preconditioned CG."""
        from ..fem.assemble import assemble_rhs_indexed

        sp = self.spaces[-1]
        geo = self.geos[-1]
        l2g = sp.local_to_global()
        mask = sp.free_mask().reshape(-1)
        rhs = jnp.asarray(
            assemble_rhs_indexed(geo, l2g, sp.degree, sp.n_dofs, mask, f),
            self.dtype,
        )
        glevels = tuple(
            MGLevel(
                op=lvl.op,
                smoother=lvl.smoother,
                transfer=(
                    FlatTransfer(
                        coarse_shape=self.spaces[i - 1].grid_shape,
                        fine_shape=self.spaces[i].grid_shape,
                        inner=lvl.transfer,
                    )
                    if lvl.transfer is not None else None
                ),
            )
            for i, lvl in enumerate(self.levels)
        )

        @jax.jit
        def run(fine_op, mg, b):
            return cg(fine_op.apply, b, mg.apply, rtol=rtol)

        mg = VCycle(pre_smoothing_steps=2, post_smoothing_steps=2,
                    levels=glevels)
        res = run(self.levels[-1].op, mg, rhs)
        stats = SolveStats(
            iterations=int(res.iterations),
            residual_norm=float(res.residual_norm),
            converged=bool(res.converged),
            solution_l2_norm=float(np.linalg.norm(np.asarray(res.x))),
            n_dofs=sp.n_dofs,
            dofs_per_level=[s.n_dofs for s in self.spaces],
        )
        if verbose:
            print(f"  Solver converged in {stats.iterations} iterations.")
        return res.x, stats

    def l2_error(self, u, u_exact) -> float:
        from ..fem.assemble import l2_error_indexed

        sp = self.spaces[-1]
        return l2_error_indexed(
            self.geos[-1], sp.local_to_global(), sp.degree,
            np.asarray(u), u_exact,
        )
