"""Grid transfers: geometric (h) and polynomial (p) prolongation/restriction.

JAX rebuild of the reference's two transfer families:

  * ``Portable::GeometricTransfer`` — h-transfer between two meshes at equal
    degree (reference: include/multigrid/portable_geometric_transfer.h:687-1487);
  * ``Portable::PolynomialTransfer`` — p-transfer on one mesh between degrees
    (reference: include/multigrid/portable_polynomial_tranfer.h:618-1268).

Both reduce, on structured tensor-product grids, to the SAME separable
per-axis schedule, so one class covers both (the reference needs ~2600 LoC of
kernels + index harvesting for the pair):

  prolongate:  for each axis: split coarse windows (stride p_c) ->
               1D contraction with M1[w_f, q_c] -> overlap-add at fine stride
               -> multiply by the separable fine weight-and-mask grid.
  restrict:    the exact transpose: weights first (reference applies weights
               before the contraction too:
               include/multigrid/portable_geometric_transfer.h:471-478), then
               per-axis windows at fine stride, M1^T, overlap-add at coarse
               stride, coarse mask last.

Weights are the reference's 1/valence fine-DoF weights with constrained DoFs
zeroed (reference: include/multigrid/portable_geometric_transfer.h:1337-1355).
On a structured grid the valence is a product of per-axis factors (2 at
interior coarse-cell boundaries, 1 elsewhere), hence exactly separable; the
Dirichlet mask is separable too, so both fold into one 1D vector per axis.

h-transfer: M1 = combined two-child embedding [2p+1, p+1], coarse stride p,
fine stride 2p.  p-transfer: M1 = degree embedding [p_f+1, p_c+1], strides
p_c / p_f.  Restriction is the exact transpose of prolongation in both cases,
matching the reference's kernels by construction.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..fem.basis import h_prolongation_matrix_1d, p_prolongation_matrix_1d
from ..fem.space import FESpace
from ..utils.pytree import pytree_dataclass, static_field
from .structured import PRECISION, contract, overlap_add, split_windows


def _contract_unrolled(t: jnp.ndarray, M: jnp.ndarray, axis: int,
                       transpose: bool = False) -> jnp.ndarray:
    """1D contraction unrolled into scalar broadcast-FMAs (elementwise code).

    The window contractions have K = p+1 (or 2p+1), too small to feed a
    matrix unit; unrolled, XLA fuses them into elementwise kernels.
    ``transpose`` contracts with M^T instead."""
    import jax

    w_out = M.shape[1] if transpose else M.shape[0]
    w_in = M.shape[0] if transpose else M.shape[1]
    outs = []
    for o in range(w_out):
        acc = None
        for j in range(w_in):
            m = M[j, o] if transpose else M[o, j]
            term = m * jax.lax.index_in_dim(t, j, axis, keepdims=False)
            acc = term if acc is None else acc + term
        outs.append(acc)
    return jnp.stack(outs, axis=axis)


@pytree_dataclass
class Transfer:
    """Two-level transfer on structured grids (covers h- and p-coarsening)."""

    dim: int = static_field()
    n_coarse: tuple = static_field()  # coarse cells per axis (tuple)
    stride_c: int = static_field()  # p_coarse
    stride_f: int = static_field()  # 2p (h) or p_fine (p)
    # contraction engine: "unrolled" (scalar broadcast-FMAs: the window
    # contractions have K = p+1 or 2p+1, too small for a matrix unit) or
    # "dot" (tensordot at HIGHEST precision).  Identical algebra; see
    # _default_algo for which one the factories pick.
    algo: str = static_field(default="dot")
    M1: jnp.ndarray = None  # [stride_f+1, stride_c+1] 1D prolongation
    wmask_f: tuple = None  # per-axis [N_f] fine weights * fine mask factors
    mask_c1: tuple = None  # per-axis [N_c] coarse mask factors

    def _wf(self, ax: int) -> jnp.ndarray:
        shp = [1] * self.dim
        shp[ax] = self.wmask_f[ax].shape[0]
        return self.wmask_f[ax].reshape(shp)

    def _mc(self, ax: int) -> jnp.ndarray:
        shp = [1] * self.dim
        shp[ax] = self.mask_c1[ax].shape[0]
        return self.mask_c1[ax].reshape(shp)

    def prolongate(self, c: jnp.ndarray) -> jnp.ndarray:
        """P c: coarse grid -> fine grid (both masked, fine side weighted).

        Accepts an optional leading component axis (vector-valued fields,
        e.g. elasticity): transfers apply component-wise.
        """
        if c.ndim == self.dim + 1:
            import jax

            return jax.vmap(self.prolongate)(c)
        t = c
        for ax in range(self.dim):
            t = t * self._mc(ax)  # constrained coarse DoFs read zero
        for ax in range(self.dim):
            t = split_windows(t, ax, self.n_coarse[ax], self.stride_c)
            if self.algo == "unrolled":
                t = _contract_unrolled(t, self.M1, ax + 1)
            else:
                t = contract(t, self.M1, ax + 1)
            t = overlap_add(t, ax, self.n_coarse[ax], self.stride_f)
            t = t * self._wf(ax)
        return t

    def prolongate_and_add(self, dst: jnp.ndarray, c: jnp.ndarray) -> jnp.ndarray:
        """dst + P c (reference: portable_geometric_transfer.h:760-823)."""
        return dst + self.prolongate(c)

    def restrict(self, f: jnp.ndarray) -> jnp.ndarray:
        """P^T f: fine grid -> coarse grid (exact transpose of prolongate)."""
        if f.ndim == self.dim + 1:
            import jax

            return jax.vmap(self.restrict)(f)
        t = f
        for ax in range(self.dim):
            t = t * self._wf(ax)  # weights BEFORE the contraction
        for ax in range(self.dim):
            t = split_windows(t, ax, self.n_coarse[ax], self.stride_f)
            if self.algo == "unrolled":
                t = _contract_unrolled(t, self.M1, ax + 1, transpose=True)
            else:
                t = jnp.moveaxis(
                    jnp.tensordot(t, self.M1, axes=((ax + 1,), (0,)),
                                  precision=PRECISION),
                    -1, ax + 1,
                )
            t = overlap_add(t, ax, self.n_coarse[ax], self.stride_c)
            t = t * self._mc(ax)  # masked scatter on constrained coarse DoFs
        return t

    def restrict_and_add(self, dst: jnp.ndarray, f: jnp.ndarray) -> jnp.ndarray:
        """dst + P^T f (reference: portable_geometric_transfer.h:825-888)."""
        return dst + self.restrict(f)


def _weights_1d(n_coarse: int, stride_f: int) -> np.ndarray:
    """Per-axis 1/valence weights on the fine grid: 0.5 at interior
    coarse-cell boundary points, 1 elsewhere."""
    N_f = n_coarse * stride_f + 1
    w = np.ones(N_f)
    if n_coarse > 1:
        w[stride_f:-1:stride_f] = 0.5
    return w


def _default_algo(dtype) -> str:
    """"unrolled" for f32 (the production V-cycle dtype); "dot" for f64,
    where the unrolled slice/stack graph makes XLA CPU compiles of
    8-device sharded programs pathologically slow.  The f32 choice is
    untuned on the H100 (see PERF.md)."""
    return "unrolled" if dtype == jnp.float32 else "dot"


def make_h_transfer(coarse: FESpace, fine: FESpace, dtype=jnp.float64) -> Transfer:
    """Geometric transfer between two uniformly refined levels, equal degree."""
    if coarse.degree != fine.degree:
        raise ValueError("h-transfer requires equal degrees")
    if fine.mesh.cells_per_axis != 2 * coarse.mesh.cells_per_axis:
        raise ValueError("fine mesh must be one refinement of the coarse mesh")
    p = coarse.degree
    n_c = coarse.mesh.cells_per_axis
    dim = coarse.dim
    M1 = h_prolongation_matrix_1d(p)  # [2p+1, p+1]
    w = _weights_1d(n_c, 2 * p) * fine.free_mask_1d()
    return Transfer(
        dim=dim,
        n_coarse=(n_c,) * dim,
        stride_c=p,
        stride_f=2 * p,
        algo=_default_algo(dtype),
        M1=jnp.asarray(M1, dtype),
        wmask_f=(jnp.asarray(w, dtype),) * dim,
        mask_c1=(jnp.asarray(coarse.free_mask_1d(), dtype),) * dim,
    )


def make_p_transfer(coarse: FESpace, fine: FESpace, dtype=jnp.float64) -> Transfer:
    """Polynomial transfer on one mesh between degrees p_coarse < p_fine."""
    if coarse.mesh.cells_per_axis != fine.mesh.cells_per_axis:
        raise ValueError("p-transfer requires the same mesh")
    n = coarse.mesh.cells_per_axis
    dim = coarse.dim
    M1 = p_prolongation_matrix_1d(coarse.degree, fine.degree)
    w = _weights_1d(n, fine.degree) * fine.free_mask_1d()
    return Transfer(
        dim=dim,
        n_coarse=(n,) * dim,
        stride_c=coarse.degree,
        stride_f=fine.degree,
        algo=_default_algo(dtype),
        M1=jnp.asarray(M1, dtype),
        wmask_f=(jnp.asarray(w, dtype),) * dim,
        mask_c1=(jnp.asarray(coarse.free_mask_1d(), dtype),) * dim,
    )
