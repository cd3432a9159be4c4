"""Structured hyper-cube meshes and their refinement hierarchies (host-side).

JAX replacement for the subset of deal.II meshing the reference
exercises: ``GridGenerator::hyper_cube`` + ``refine_global`` (reference:
source/geometric_multigrid/program.cc:409-417) and
``MGTransferGlobalCoarseningTools::create_geometric_coarsening_sequence``
(reference: source/geometric_multigrid/program.cc:144-146).  On a uniformly
refined hyper-cube the geometric coarsening sequence is exactly the ladder of
refinement stages, so the "forest of octrees" machinery collapses to an
integer per level: the number of cells per axis.

Cells, DoFs and quadrature points are all enumerated lexicographically
(x fastest ... for numpy C-order arrays we use the convention that axis 0 is
the slowest; element/DoF grids are plain ndarrays so the enumeration is
implicit and no ``lexicographic_numbering`` table is needed — compare
reference: include/operators/portable_laplace_operator.h:494-507).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HyperCubeMesh:
    """A uniformly refined hyper-cube [a, b]^dim with 2^refinements cells/axis."""

    dim: int
    refinements: int
    a: float = 0.0
    b: float = 1.0

    def __post_init__(self):
        if self.dim not in (1, 2, 3):
            raise ValueError("dim must be 1, 2 or 3")
        if self.refinements < 0:
            raise ValueError("refinements must be >= 0")

    @property
    def cells_per_axis(self) -> int:
        return 1 << self.refinements

    @property
    def n_cells(self) -> int:
        return self.cells_per_axis**self.dim

    @property
    def h(self) -> float:
        return (self.b - self.a) / self.cells_per_axis

    def refine(self) -> "HyperCubeMesh":
        return dataclasses.replace(self, refinements=self.refinements + 1)

    def coarsen(self) -> "HyperCubeMesh":
        if self.refinements == 0:
            raise ValueError("cannot coarsen the base mesh")
        return dataclasses.replace(self, refinements=self.refinements - 1)


def geometric_coarsening_sequence(mesh: HyperCubeMesh) -> list[HyperCubeMesh]:
    """All coarsening stages, coarsest first (the base 1-cell hyper-cube),
    finest last — mirroring create_geometric_coarsening_sequence on a
    globally refined mesh (reference: source/geometric_multigrid/program.cc:144-146).
    """
    return [
        dataclasses.replace(mesh, refinements=r)
        for r in range(0, mesh.refinements + 1)
    ]
