"""portable_multigrid_tpu — matrix-free multigrid framework in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of
dealii-X/portable-multigrid (GPU-portable matrix-free geometric and polynomial
multigrid for Poisson-type problems with continuous Q_p elements):

  * setup (meshes, DoFs, constraints, 1D matrices, geometry) is host-side
    NumPy producing flat tensor-grid arrays;
  * the entire solve — CG + V-cycle + Chebyshev smoothing + transfers +
    operator applies — is one jitted, purely functional program;
  * gather/scatter are structured reshapes/overlap-adds (no atomics, no cell
    coloring), so the summation order is fixed by the program; on a GPU,
    XLA's choice of library kernel can still move the last bits between
    runs (the convergence tests hold iteration counts, not bits);
  * multi-device runs shard elements over a `jax.sharding.Mesh` with halo
    plane exchange via collectives (parallel subpackage).

See SURVEY.md for the complete component-by-component mapping to the
reference.
"""

from .fem.mesh import HyperCubeMesh, geometric_coarsening_sequence
from .fem.space import FESpace
from .fem.assemble import assemble_rhs, dense_operator, l2_norm
from .ops.laplace import LaplaceOperator, make_laplace
from .ops.transfer import Transfer, make_h_transfer, make_p_transfer
from .solvers.cg import cg, cg_fixed_iterations
from .solvers.chebyshev import Chebyshev, make_chebyshev
from .solvers.vcycle import MGLevel, VCycle
from .models.poisson import (
    GeometricMultigridPoisson,
    PolynomialMultigridPoisson,
)
from .models.mixed import MixedMultigridPoisson, MixedPrecisionPoisson
from .models.general_geometry import GeneralGeometryMultigrid
from .models.elasticity import ElasticityMultigrid
from .ops.elasticity import ElasticityOperator, make_elasticity
from .ops.indexed import (
    IndexedLaplaceOperator,
    make_indexed_laplace,
    make_unstructured_laplace,
)
from .fem.general_mesh import GeneralMesh, perturbed_cube_mesh

__version__ = "0.1.0"

__all__ = [
    "HyperCubeMesh",
    "geometric_coarsening_sequence",
    "FESpace",
    "assemble_rhs",
    "dense_operator",
    "l2_norm",
    "LaplaceOperator",
    "make_laplace",
    "Transfer",
    "make_h_transfer",
    "make_p_transfer",
    "cg",
    "cg_fixed_iterations",
    "Chebyshev",
    "make_chebyshev",
    "MGLevel",
    "VCycle",
    "GeometricMultigridPoisson",
    "PolynomialMultigridPoisson",
    "MixedMultigridPoisson",
    "GeneralGeometryMultigrid",
    "MixedPrecisionPoisson",
    "ElasticityMultigrid",
    "ElasticityOperator",
    "make_elasticity",
    "IndexedLaplaceOperator",
    "make_indexed_laplace",
    "make_unstructured_laplace",
    "GeneralMesh",
    "perturbed_cube_mesh",
]
