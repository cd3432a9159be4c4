"""Q_p finite-element spaces on structured hyper-cube meshes (host-side).

JAX replacement for the deal.II DoF layer the reference consumes:
``FE_Q<dim>`` + ``DoFHandler::distribute_dofs`` (reference:
source/geometric_multigrid/program.cc:77-78,154-158) and the Dirichlet
constraint masks (reference:
include/operators/portable_laplace_operator.h:487-555, where a per-cell,
per-DoF table maps constrained lexicographic DoFs to invalid indices).

Design: on a structured mesh the global DoFs of Q_p form a tensor grid of
(n*p+1)^dim points, so a DoF vector IS a dim-dimensional array and the
cell→DoF map is pure index arithmetic.  Constraints (homogeneous Dirichlet on
the whole boundary, boundary_id 0 — reference:
source/geometric_multigrid/program.cc:84,130,163-186; uniform refinement means
no hanging nodes, see the FIXME at
include/multigrid/portable_geometric_transfer.h:24-25) reduce to a global
0/1 mask over that grid.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .basis import Basis1D, make_basis
from .mesh import HyperCubeMesh


@dataclasses.dataclass(frozen=True)
class FESpace:
    """Continuous Q_degree Lagrange space on a structured hyper-cube mesh."""

    mesh: HyperCubeMesh
    degree: int

    def __post_init__(self):
        if self.degree < 1:
            raise ValueError("degree must be >= 1")

    @property
    def dim(self) -> int:
        return self.mesh.dim

    @property
    def points_per_axis(self) -> int:
        return self.mesh.cells_per_axis * self.degree + 1

    @property
    def grid_shape(self) -> tuple[int, ...]:
        return (self.points_per_axis,) * self.dim

    @property
    def n_dofs(self) -> int:
        return self.points_per_axis**self.dim

    @property
    def basis(self) -> Basis1D:
        return make_basis(self.degree)

    # ------------------------------------------------------------------
    # constraints / masks
    # ------------------------------------------------------------------

    def free_mask_1d(self) -> np.ndarray:
        """1D factor of the Dirichlet mask: 0 at the two boundary points."""
        m = np.ones(self.points_per_axis)
        m[0] = 0.0
        m[-1] = 0.0
        return m

    def free_mask(self) -> np.ndarray:
        """Grid mask, 1.0 on free DoFs, 0.0 on (Dirichlet-)constrained DoFs.

        Homogeneous Dirichlet on the entire hyper-cube boundary, matching the
        reference's interpolate_boundary_values on boundary_id 0 (reference:
        source/geometric_multigrid/program.cc:163-186).
        """
        m1 = self.free_mask_1d()
        m = m1
        for _ in range(self.dim - 1):
            m = np.multiply.outer(m, m1)
        return m

    def n_free_dofs(self) -> int:
        return int(self.points_per_axis - 2) ** self.dim if self.degree else 0

    # ------------------------------------------------------------------
    # indexed (general/unstructured-style) cell -> global DoF map
    # ------------------------------------------------------------------

    def local_to_global(self) -> np.ndarray:
        """Per-cell gather table l2g[E, (p+1)^dim], lexicographic local DoFs.

        The indexed-path analog of ``precomputed_data.local_to_global(i, cell)``
        (reference: include/operators/portable_laplace_operator.h:251-257).
        Local and global orderings are both lexicographic with axis 0 slowest,
        so no renumbering is required.
        """
        n = self.mesh.cells_per_axis
        p = self.degree
        N = self.points_per_axis
        ax = np.arange(n)[:, None] * p + np.arange(p + 1)[None, :]  # [n, p+1]
        if self.dim == 1:
            return ax.astype(np.int64)
        if self.dim == 2:
            g = (
                ax[:, None, :, None] * N
                + ax[None, :, None, :]
            )  # [n, n, p+1, p+1]
            return g.reshape(n * n, (p + 1) ** 2).astype(np.int64)
        g = (
            ax[:, None, None, :, None, None] * N * N
            + ax[None, :, None, None, :, None] * N
            + ax[None, None, :, None, None, :]
        )
        return g.reshape(n**3, (p + 1) ** 3).astype(np.int64)

    # ------------------------------------------------------------------
    # coordinates
    # ------------------------------------------------------------------

    def dof_points_1d(self) -> np.ndarray:
        """Physical coordinates of the DoF grid along one axis."""
        nodes = self.basis.nodes  # on [0,1]
        n = self.mesh.cells_per_axis
        h = self.mesh.h
        pts = self.mesh.a + h * (np.arange(n)[:, None] + nodes[None, :])
        return np.concatenate([pts[:, :-1].reshape(-1), [self.mesh.b]])
