"""Multi-chip sharding: halo plane exchange + sharded operator/transfer wrappers.

JAX replacement for the reference's MPI domain decomposition
(SURVEY.md §2.3 item 1): deal.II partitions cells across ranks and exchanges
ghost DoFs on reads (``update_ghost_values``) and owner-sums boundary
contributions on writes (``compress(add)``) around every operator/transfer
apply (reference: include/operators/portable_laplace_operator.h:635-657,713;
include/multigrid/portable_geometric_transfer.h:779-818).

Here the DoF grid is sliced into cell slabs along grid axis 0, one slab per
chip, with the single shared DoF plane between neighboring slabs stored
*duplicated and consistent* on both.  Then:

  * elementwise ops (masks, Chebyshev recurrences, axpys) need no
    communication at all — duplicates stay consistent by construction;
  * every scatter-producing op (operator apply, prolongation, restriction)
    is the local structured kernel followed by ONE bidirectional plane
    exchange (`halo_sum`: each chip ppermutes its partial boundary planes to
    its neighbors and adds what it receives) — this fuses deal.II's
    update_ghost_values + compress(add) pair into a single nearest-neighbor
    collective (a ppermute, which XLA lowers to NCCL on GPUs);
  * inner products weight the duplicated planes by 1/2 and psum — the analog
    of deal.II's owned-dof dot + MPI_Allreduce.

Everything runs inside one ``jax.shard_map`` region over a 1D device mesh;
the wrappers below are pytrees, so whole multigrid hierarchies of them pass
through jit unchanged.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ops.laplace import LaplaceOperator
from ..ops.transfer import Transfer
from ..utils.pytree import pytree_dataclass, static_field


def halo_sum(
    t: jnp.ndarray, axis_name: str, n_shards: int, axis: int = 0
) -> jnp.ndarray:
    """Sum duplicated boundary-plane contributions with both neighbors.

    t is the local slab with the sharded grid direction at ``axis`` (0 for
    scalar fields, 1 for component-major vector fields); plane 0 is shared
    with the left neighbor's plane -1 and vice versa.  Non-existent
    neighbors contribute zeros (ppermute semantics).
    """
    if n_shards == 1:
        return t
    if axis != 0:
        t = jnp.moveaxis(t, axis, 0)
    fwd = [(i, i + 1) for i in range(n_shards - 1)]
    bwd = [(i + 1, i) for i in range(n_shards - 1)]
    from_left = jax.lax.ppermute(t[-1:], axis_name, fwd)
    from_right = jax.lax.ppermute(t[:1], axis_name, bwd)
    t = t.at[:1].add(from_left).at[-1:].add(from_right)
    if axis != 0:
        t = jnp.moveaxis(t, 0, axis)
    return t


@pytree_dataclass
class ShardedLaplaceOperator:
    """Laplace operator on a slab-sharded grid: local kernel + halo_sum.

    The constraint-mask combine runs after the halo (masks are consistent on
    duplicated planes), preserving the reference's A_eff = M A M + (I - M)
    semantics globally.
    """

    axis_name: str = static_field()
    n_shards: int = static_field()
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
        au = halo_sum(au, self.axis_name, self.n_shards)
        return loc.mask * au + (1.0 - loc.mask) * u

    vmult = apply


@pytree_dataclass
class ShardedTransfer:
    """Two-level transfer on slab-sharded grids: local transfer + halo_sum.

    Both prolongation and restriction end in an axis-0 overlap-add whose
    shard-boundary contributions are completed by one plane exchange; the
    separable weight/mask multiplies commute with the halo because they are
    consistent on duplicated planes.
    """

    axis_name: str = static_field()
    n_shards: int = static_field()
    # the sharded GRID axis of the fields this transfer moves: 0 for scalar
    # fields, 1 for component-major vector fields (elasticity) — halo-summing
    # axis 0 of a vector field would exchange planes along the COMPONENT
    # axis, and a multi-level sharded elasticity solve then converges to
    # a wrong answer (tests/test_sharding.py::test_sharded_elasticity_*)
    halo_axis: int = static_field(default=0)
    local: Transfer = None

    def prolongate(self, c: jnp.ndarray) -> jnp.ndarray:
        return halo_sum(self.local.prolongate(c), self.axis_name,
                        self.n_shards, axis=self.halo_axis)

    def prolongate_and_add(self, dst: jnp.ndarray, c: jnp.ndarray) -> jnp.ndarray:
        return dst + self.prolongate(c)

    def restrict(self, f: jnp.ndarray) -> jnp.ndarray:
        return halo_sum(self.local.restrict(f), self.axis_name,
                        self.n_shards, axis=self.halo_axis)

    def restrict_and_add(self, dst: jnp.ndarray, f: jnp.ndarray) -> jnp.ndarray:
        return dst + self.restrict(f)


def make_sharded_dot(
    dot_weight_axis0: jnp.ndarray, dim: int, axis_name: str, lead_axes: int = 0
):
    """Duplicate-plane-weighted inner product with psum over the mesh axis.

    dot_weight_axis0: [N_loc] with 0.5 on planes duplicated with a neighbor,
    1.0 elsewhere; ``lead_axes`` leading (component) axes precede the
    sharded grid axis.  The analog of deal.II's owned-partition dot followed
    by the implicit MPI allreduce (SURVEY.md §5, distributed backend).
    """
    w = dot_weight_axis0.reshape(
        (1,) * lead_axes + (-1,) + (1,) * (dim - 1)
    )

    def dot(a: jnp.ndarray, b: jnp.ndarray):
        return jax.lax.psum(
            jnp.vdot(a * w, b, precision=jax.lax.Precision.HIGHEST),
            axis_name)

    return dot


@pytree_dataclass
class ShardedElasticityOperator:
    """Vector-valued elasticity on slab-sharded grids (component axis 0)."""

    axis_name: str = static_field()
    n_shards: int = static_field()
    local: object = None  # ElasticityOperator with local slab arrays

    @property
    def inv_diag(self):
        return self.local.inv_diag

    @property
    def mask(self):
        return self.local.mask

    def apply(self, u: jnp.ndarray) -> jnp.ndarray:
        loc = self.local
        u = u.reshape(loc.shape)
        m = loc.mask[None]
        au = loc.apply_bilinear(u * m)
        au = halo_sum(au, self.axis_name, self.n_shards, axis=1)
        return m * au + (1.0 - m) * u

    vmult = apply


@pytree_dataclass
class GatherTransfer:
    """Boundary transfer between a slab-SHARDED fine level and a REPLICATED
    coarse level.

    The reference coarsens to the 1-cell base mesh regardless of rank count
    (reference: source/geometric_multigrid/program.cc:137-147); below the
    shard granularity (fewer cell slabs than devices) the answer here is
    to replicate those ultra-coarse levels on every device:

      * restrict: all_gather the consistent fine slabs, reassemble
        the full fine grid (dropping the duplicated planes) and restrict
        locally — every chip deterministically computes the same full coarse
        grid, so the replicated sub-hierarchy needs no further collectives;
      * prolongate: run the full-grid prolongation locally (the boundary
        level is tiny) and slice out this chip's slab.

    ``local`` is the ordinary full-grid Transfer for the level pair.
    """

    axis_name: str = static_field()
    n_shards: int = static_field()
    slab_stride: int = static_field()  # fine-grid points per shard offset
    n_loc_points: int = static_field()  # fine slab extent incl. shared plane
    local: Transfer = None

    def _assemble_full(self, f_slab: jnp.ndarray) -> jnp.ndarray:
        st = jax.lax.all_gather(f_slab, self.axis_name)  # [S, N_loc, ...]
        parts = [st[0]] + [st[s][1:] for s in range(1, self.n_shards)]
        return jnp.concatenate(parts, axis=0)

    def restrict(self, f_slab: jnp.ndarray) -> jnp.ndarray:
        return self.local.restrict(self._assemble_full(f_slab))

    def restrict_and_add(self, dst: jnp.ndarray, f_slab: jnp.ndarray):
        return dst + self.restrict(f_slab)

    def prolongate(self, c_full: jnp.ndarray) -> jnp.ndarray:
        f_full = self.local.prolongate(c_full)
        s = jax.lax.axis_index(self.axis_name)
        return jax.lax.dynamic_slice_in_dim(
            f_full, s * self.slab_stride, self.n_loc_points, axis=0
        )

    def prolongate_and_add(self, dst: jnp.ndarray, c_full: jnp.ndarray):
        return dst + self.prolongate(c_full)


# --------------------------------------------------------------------------
# host-side partitioning helpers
# --------------------------------------------------------------------------


def slab_bounds(n_cells: int, degree: int, n_shards: int):
    """Grid index ranges [start, stop) per shard, including the duplicated
    boundary planes (stop - start = n_loc * p + 1)."""
    if n_cells % n_shards != 0:
        raise ValueError(
            f"cells per axis ({n_cells}) must be divisible by n_shards ({n_shards})"
        )
    n_loc = n_cells // n_shards
    return [
        (s * n_loc * degree, (s + 1) * n_loc * degree + 1) for s in range(n_shards)
    ]


def partition_axis0(arr, n_cells: int, degree: int, n_shards: int):
    """Stack per-shard slabs of a global grid array: [N, ...] -> [S, N_loc, ...]."""
    import numpy as np

    bounds = slab_bounds(n_cells, degree, n_shards)
    return np.stack([np.asarray(arr)[b0:b1] for (b0, b1) in bounds])


def unpartition_axis0(stacked, n_cells: int, degree: int, n_shards: int):
    """Invert partition_axis0 (duplicated planes taken from the left owner)."""
    import numpy as np

    parts = [np.asarray(stacked[s])[:-1] for s in range(n_shards - 1)]
    parts.append(np.asarray(stacked[n_shards - 1]))
    return np.concatenate(parts, axis=0)


def shard_placement(x) -> tuple:
    """((device, shard shape), ...) for every addressable piece of a
    sharded array, in device-id order."""
    return tuple(
        (str(sh.device), tuple(sh.data.shape))
        for sh in sorted(x.addressable_shards, key=lambda sh: sh.device.id)
    )


def dot_weights_axis0(n_cells: int, degree: int, n_shards: int):
    """Per-shard [S, N_loc] reduction weights: 0.5 on duplicated planes."""
    import numpy as np

    bounds = slab_bounds(n_cells, degree, n_shards)
    out = []
    for s, (b0, b1) in enumerate(bounds):
        w = np.ones(b1 - b0)
        if s > 0:
            w[0] = 0.5
        if s < n_shards - 1:
            w[-1] = 0.5
        out.append(w)
    return np.stack(out)


def estimate_eigenvalues_sharded(
    op_stacked,
    mesh,
    axis_name: str,
    n_shards: int,
    dot_weight_stacked,
    dim: int,
    n_iter: int,
    v0_stacked,
):
    """CG-Lanczos eigenvalue estimation run INSIDE shard_map.

    The 1D-mesh analog of solvers/chebyshev.py:estimate_eigenvalues, for
    levels too large for a single-device twin: the level operator applies
    shard-locally with halo exchange and the CG coefficients reduce with the
    duplicate-plane-weighted psum dot.  Returns (min_eig, max_eig).
    """
    import numpy as np
    from jax.sharding import PartitionSpec as P

    from ..solvers.chebyshev import estimate_eigenvalues

    def run_local(op_st, w_st, v_st):
        import jax.tree_util as jtu

        op_loc = jtu.tree_map(lambda a: a[0], op_st)
        sop = ShardedLaplaceOperator(
            axis_name=axis_name, n_shards=n_shards, local=op_loc
        )
        dot = make_sharded_dot(w_st[0], dim, axis_name)
        b = v_st[0]
        r = b
        x = jnp.zeros_like(b)
        z = sop.inv_diag * r
        rz = dot(r, z)

        def step(carry, _):
            x, r, p, rz, stop = carry
            Ap = sop.apply(p)
            pAp = dot(p, Ap)
            bad = jnp.logical_or(stop, pAp <= 0.0)
            alpha = jnp.where(bad, jnp.inf, rz / jnp.where(pAp == 0, 1.0, pAp))
            x = x + jnp.where(bad, 0.0, alpha) * p
            r = r - jnp.where(bad, 0.0, alpha) * Ap
            z = sop.inv_diag * r
            rz_new = dot(r, z)
            beta = jnp.where(bad, 0.0, rz_new / jnp.where(rz == 0, 1.0, rz))
            p = z + beta * p
            stop = jnp.logical_or(bad, rz_new <= 1e-300)
            return (x, r, p, rz_new, stop), (alpha, beta)

        _, (alphas, betas) = jax.lax.scan(
            step, (x, r, z, rz, jnp.bool_(False)), None, length=n_iter
        )
        return alphas, betas

    f = jax.jit(
        jax.shard_map(
            run_local,
            mesh=mesh,
            in_specs=(P(axis_name), P(axis_name), P(axis_name)),
            out_specs=(P(), P()),
            check_vma=False,
        )
    )
    alphas, betas = f(op_stacked, dot_weight_stacked, v0_stacked)
    # reuse the host-side Lanczos tridiagonal post-processing
    alphas = np.asarray(alphas, dtype=np.float64)
    betas = np.asarray(betas, dtype=np.float64)
    valid = np.isfinite(alphas) & (alphas != 0)
    k = int(np.sum(np.cumprod(valid)))
    if k == 0:
        return 1.0, 1.0
    a, b = alphas[:k], betas[:k]
    diag = 1.0 / a
    diag[1:] += b[:-1] / a[:-1]
    off = np.sqrt(np.maximum(b[:-1], 0.0)) / a[:-1]
    T = np.diag(diag)
    if k > 1:
        T += np.diag(off, 1) + np.diag(off, -1)
    ev = np.linalg.eigvalsh(T)
    return float(ev[0]), float(ev[-1])
