"""Matrix-free Laplace operator: sum-factorized element apply (JAX/XLA).

JAX rebuild of the reference's hot path
(``Portable::LaplaceOperator::vmult`` + ``LocalLaplaceOperator``, reference:
include/operators/portable_laplace_operator.h:557-719 and :212-381):

  masked gather -> basis change to quadrature collocation space ->
  collocation gradients -> per-q-point metric application ->
  transposed collocation gradients -> basis change back -> masked scatter ->
  Dirichlet rows = identity (copy_constrained_values, reference :718).

Differences by design (SURVEY.md §7):
  * one traced program over an element-batched tensor layout instead of a
    team-per-cell kernel; XLA maps the per-direction 1D contractions onto
    matrix products and fuses the element loop;
  * gather/scatter are reshape/overlap-add (ops/structured.py), not indexed
    atomics, so the summation order does not depend on thread scheduling;
  * the per-cell Dirichlet mask table collapses to a global 0/1 grid mask —
    legal because uniform refinement produces no hanging nodes (reference
    FIXMEs local refinement away too:
    include/multigrid/portable_geometric_transfer.h:24-25);
  * Cartesian geometry is a compile-time fast path: the metric
    JxW * J^-1 J^-T is w_q * h^(dim-2) * I, so the q-point stage is a single
    broadcast multiply with zero per-cell geometry reads.

A runtime-degree dispatch factory is unnecessary: ``degree`` is static
metadata and jit retraces per degree (replacing
include/base/portable_laplace_operator_base.h:62-96).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..fem.basis import make_basis
from ..fem.space import FESpace
from ..utils.pytree import pytree_dataclass, static_field
from .structured import contract, overlap_add_all, split_all


@pytree_dataclass
class LaplaceOperator:
    """Jit-friendly matrix-free Laplace operator on a structured Q_p space.

    Static metadata: (dim, degree, n) — the compile-time shape of the kernel,
    playing the role of the reference's template parameters.  Array fields:
    1D shape matrices, quadrature/metric weights, and the global free-DoF mask.
    """

    dim: int = static_field()
    degree: int = static_field()
    n: tuple = static_field()  # cells per axis (tuple; differ on sharded slabs)
    # "sumfac" | "dense" | "kron" | "bkron" | "qdense" | "qbanded"
    variant: str = static_field(default="sumfac")
    # matmul precision of every contraction: "highest" = full f32 (or f64)
    # arithmetic.  On a GPU "high" and "default" let f32 products run in
    # TF32 (about three decimal digits), which costs CG iterations when it
    # reaches a residual; the production path keeps "highest" everywhere.
    precision: str = static_field(default="highest")
    B: jnp.ndarray = None  # [nq, p+1] shape values at quad points
    Dco: jnp.ndarray = None  # [nq, nq] collocation derivative
    qmetric: jnp.ndarray = None  # [nq]*dim tensor: w_q ⊗ ... ⊗ w_q * h^(dim-2)
    # Separable constraint-mask / diagonal storage: the grid mask and the
    # matrix diagonal of the Cartesian operator are (sums of) outer products
    # of per-axis 1D vectors, so only the 1D factors are stored; the grid
    # fields are materialized lazily (fused broadcasts under jit).  This
    # keeps captured jit constants O(N) instead of O(N^dim) and turns every
    # inv_diag read from an HBM stream into (cheap) recompute.
    mask1: tuple = None  # per-axis [N_d] free-DoF mask factors
    dK1: tuple = None  # per-axis assembled 1D stiffness diagonals (h-folded)
    dM1: tuple = None  # per-axis assembled 1D mass diagonals
    # escape hatches for non-separable cases (variable coefficients,
    # externally partitioned grids): override the lazy products when set
    mask_full: jnp.ndarray = None
    inv_diag_full: jnp.ndarray = None
    elem_matrix: jnp.ndarray = None  # [(p+1)^dim]^2 element matrix ("dense")
    Kg: tuple = None  # per-axis assembled 1D stiffness [N_d, N_d] ("kron")
    Mg: tuple = None  # per-axis assembled 1D mass [N_d, N_d] ("kron")
    # "bkron" variant: the SAME assembled 1D matrices in block-tridiagonal
    # form [nb, 3, 128, 128] (the band halfwidth p < 128, so every nonzero
    # of block-row i lives in block-columns i-1..i+1).  Each 1D contraction
    # is then 3 batched matmuls — O(N * 384 * M) FLOPs instead of the
    # dense kron's O(N^2 * M), which is what makes large-N grids (the 2D
    # drivers, where N = n*p+1 reaches 3585) affordable.  Replaces the
    # reference's 2D cell loop
    # (include/operators/portable_laplace_operator.h:227-381).
    Kb: tuple = None  # per-axis [nb, 3, 128, 128] stiffness block stacks
    Mb: tuple = None  # per-axis [nb, 3, 128, 128] mass block stacks
    # optional variable scalar coefficient c(x) sampled at quadrature points,
    # laid out [n_0*nq, n_1*nq, ...] ("sumfac" only): generalizes the q-point
    # stage exactly like the reference's pluggable geometry data (SURVEY.md §7
    # M5); None = unit coefficient.
    coef: jnp.ndarray = None
    # "qdense" variant (variable-coefficient matmul path): the element
    # gradient operator as ONE dense matrix [(p+1)^dim, dim*nq^dim]
    # (each column block d is kron over axes of Dco@B if a==d else B), and
    # the per-element q-point weights w_q h^(dim-2) c(x_q) as [E, nq^dim].
    # The apply is then flat_u @ Gmat -> scale -> @ Gmat.T — two large
    # matmuls instead of 2*dim layout-shuffling tensordots, the matmul form
    # of the reference's variable-coefficient q-point loop
    # (include/operators/portable_laplace_operator.h:300-340).
    Gmat: jnp.ndarray = None
    wcoef_e: jnp.ndarray = None
    # "qbanded" variant (variable-coefficient block-banded fast path): the
    # q-point pipeline hoisted to GLOBAL per-axis banded matrices.  The
    # nodal->quadrature interpolation Bg [n*nq, N] and the collocation
    # derivative Dg [n*nq, n*nq] are cell-block-diagonal, so each stage of
    # the reference's q-point loop (portable_laplace_operator.h:300-340)
    # is one batched matmul on the contiguous grid (ops/bblock.py) —
    # the gather/scatter element layout disappears entirely, and the
    # transposed interpolation absorbs overlap-add exactly.
    qBb: jnp.ndarray = None  # packed Bg blocks
    qBTb: jnp.ndarray = None  # packed Bg.T blocks
    qDb: jnp.ndarray = None  # packed Dg blocks
    qDTb: jnp.ndarray = None  # packed Dg.T blocks
    # ((starts, R, C) for qBb, qBTb, qDb, qDTb) — static pack metadata
    qmeta: tuple = static_field(default=None)

    # -- shapes -----------------------------------------------------------
    @property
    def grid_shape(self) -> tuple[int, ...]:
        return tuple(nd * self.degree + 1 for nd in self.n)

    @property
    def n_dofs(self) -> int:
        out = 1
        for s in self.grid_shape:
            out *= s
        return out

    def zero_vector(self) -> jnp.ndarray:
        return jnp.zeros(self.grid_shape, self.B.dtype)

    @property
    def dtype(self):
        return self.B.dtype

    # -- lazily materialized separable fields -------------------------------
    def _bc(self, v: jnp.ndarray, ax: int) -> jnp.ndarray:
        """Reshape a per-axis 1D factor for broadcasting onto the grid."""
        shp = [1] * self.dim
        shp[ax] = v.shape[0]
        return v.reshape(shp)

    @property
    def mask(self) -> jnp.ndarray:
        """Free-DoF grid mask (outer product of the per-axis factors)."""
        if self.mask_full is not None:
            return self.mask_full
        m = self._bc(self.mask1[0], 0)
        for d in range(1, self.dim):
            m = m * self._bc(self.mask1[d], d)
        return m

    @property
    def inv_diag(self) -> jnp.ndarray:
        """Inverse matrix diagonal (constrained DoFs = 1), from 1D factors.

        diag = sum_k  (x)_d (dK1[d] if d==k else dM1[d]) — the Kronecker-sum
        structure of the Cartesian operator (see _diagonal_grid)."""
        if self.inv_diag_full is not None:
            return self.inv_diag_full
        diag = None
        for k in range(self.dim):
            term = self._bc(self.dK1[0] if k == 0 else self.dM1[0], 0)
            for d in range(1, self.dim):
                term = term * self._bc(
                    self.dK1[d] if d == k else self.dM1[d], d
                )
            diag = term if diag is None else diag + term
        m = self.mask
        return 1.0 / (diag * m + (1.0 - m))

    # -- the hot kernel ----------------------------------------------------
    def apply_local(self, ue: jnp.ndarray) -> jnp.ndarray:
        """Element-local weak Laplacian on the interleaved split tensor.

        ue has cell axes at even positions and DoF axes at odd positions
        (1, 3, 5).  Mirrors the 5 stages of the reference cell kernel
        (include/operators/portable_laplace_operator.h:281-357).
        """
        dim, B, Dco = self.dim, self.B, self.Dco
        qaxes = [2 * d + 1 for d in range(dim)]

        # 1. basis change to quadrature collocation space
        v = ue
        for ax in qaxes:
            v = contract(v, B, ax, precision=self.precision)

        # 2. collocation gradients + 3. metric application (Cartesian: the
        #    metric is diagonal and cell-independent) + 4. transpose gradients
        w = self.qmetric.reshape(
            tuple(1 if a % 2 == 0 else self.B.shape[0] for a in range(2 * dim))
        )
        if self.coef is not None:
            nq = self.B.shape[0]
            shp = []
            for nd in self.n:
                shp.extend((nd, nq))
            w = w * self.coef.reshape(shp)
        r = None
        for d, ax in enumerate(qaxes):
            g = contract(v, Dco, ax, precision=self.precision) * w
            g = jnp.tensordot(g, Dco, axes=((ax,), (0,)), precision=self.precision)
            g = jnp.moveaxis(g, -1, ax)  # Dco^T along ax
            r = g if r is None else r + g

        # 5. basis change back
        for ax in qaxes:
            r = jnp.tensordot(r, B, axes=((ax,), (0,)), precision=self.precision)
            r = jnp.moveaxis(r, -1, ax)  # B^T along ax
        return r

    def apply_local_dense(self, ue: jnp.ndarray) -> jnp.ndarray:
        """Element apply as ONE matmul with the constant element matrix.

        On an affine uniformly refined mesh every cell's element matrix is
        identical (A_loc = h^(dim-2) * A_ref), so the whole element loop is a
        [E, (p+1)^dim] @ [(p+1)^dim, (p+1)^dim] matmul — the matmul
        reformulation of the reference's per-cell sum factorization (SURVEY.md
        §7 point 1; trades flops for one dense product).
        """
        dim = self.dim
        # interleaved [n0,q,n1,q,n2,q] -> [n0,n1,n2, q,q,q] -> [E, q^dim]
        perm = tuple(range(0, 2 * dim, 2)) + tuple(range(1, 2 * dim, 2))
        t = ue.transpose(perm)
        q = self.degree + 1
        E = 1
        for nd in self.n:
            E *= nd
        flat = t.reshape(E, q**dim)
        r = jnp.dot(flat, self.elem_matrix, precision=self.precision,
                    preferred_element_type=flat.dtype)
        t = r.reshape(tuple(self.n) + (q,) * dim)
        inv = [0] * (2 * dim)
        for i, p_ in enumerate(perm):
            inv[p_] = i
        return t.transpose(inv)

    def apply_local_qdense(self, ue: jnp.ndarray) -> jnp.ndarray:
        """Variable-coefficient element apply as two large matmuls.

        g = U @ G gives all dim gradient components at all q points for
        every element in one [E, (p+1)^dim] x [(p+1)^dim, dim*nq^dim]
        matmul; the metric/coefficient application is one elementwise
        scale; the transposed-gradient accumulation is the mirrored
        matmul with G^T.  Same quadrature as ``apply_local`` — equal to
        roundoff (tests/test_operator.py::test_qdense_matches_sumfac)."""
        dim = self.dim
        perm = tuple(range(0, 2 * dim, 2)) + tuple(range(1, 2 * dim, 2))
        t = ue.transpose(perm)
        q = self.degree + 1
        E = 1
        for nd in self.n:
            E *= nd
        flat = t.reshape(E, q**dim)
        g = jnp.dot(flat, self.Gmat, precision=self.precision,
                    preferred_element_type=flat.dtype)
        nqd = self.Gmat.shape[1] // dim
        g = (g.reshape(E, dim, nqd) * self.wcoef_e[:, None, :]).reshape(
            E, dim * nqd
        )
        r = jnp.dot(g, self.Gmat.T, precision=self.precision,
                    preferred_element_type=flat.dtype)
        t = r.reshape(tuple(self.n) + (q,) * dim)
        inv = [0] * (2 * dim)
        for i, p_ in enumerate(perm):
            inv[p_] = i
        return t.transpose(inv)

    def apply_kron(self, um: jnp.ndarray) -> jnp.ndarray:
        """Apply via assembled per-axis 1D matrices (Kronecker-sum form).

        On a tensor-product mesh with Cartesian geometry the ASSEMBLED
        operator factorizes globally:  A = sum_k M x ... K(k) ... x M with
        banded 1D assembled stiffness/mass matrices — assembly (gather +
        overlap-add) is absorbed into the 1D matrices, so the whole apply is
        2*dim + (dim-1) large matmuls on the contiguous DoF grid with NO
        layout shuffles.  A reformulation of the reference's cell loop (same
        quadrature, exact same matrix: both equal the assembled Galerkin
        operator)."""

        def ctr(t, W, ax):
            out = jnp.tensordot(t, W, axes=((ax,), (1,)), precision=self.precision)
            return jnp.moveaxis(out, -1, ax)

        dim = self.dim
        if dim == 1:
            return ctr(um, self.Kg[0], 0)
        if dim == 2:
            b = ctr(um, self.Mg[1], 1)
            a = ctr(um, self.Kg[1], 1)
            return ctr(b, self.Kg[0], 0) + ctr(a, self.Mg[0], 0)
        # dim == 3: 8 passes with common-subexpression sharing
        b = ctr(um, self.Mg[2], 2)  # M_z u
        a = ctr(um, self.Kg[2], 2)  # K_z u
        mb = ctr(b, self.Mg[1], 1)
        kb = ctr(b, self.Kg[1], 1)
        ma = ctr(a, self.Mg[1], 1)
        return (
            ctr(mb, self.Kg[0], 0)
            + ctr(kb + ma, self.Mg[0], 0)
        )

    def _bctr(self, t: jnp.ndarray, Wb: jnp.ndarray, ax: int) -> jnp.ndarray:
        """Contract axis ``ax`` of ``t`` with the block-tridiagonal matrix
        ``Wb`` [nb, 3, B, B]: y_i = Wb[i,0] x_{i-1} + Wb[i,1] x_i +
        Wb[i,2] x_{i+1} on 128-row block slices (zero blocks off the ends).
        Three batched matmuls; pad/slice handles N % 128 != 0."""
        N = t.shape[ax]
        t = jnp.moveaxis(t, ax, 0)
        rest = t.shape[1:]
        nb, _, B, _ = Wb.shape
        tp = t.reshape(N, -1)
        if nb * B != N:
            tp = jnp.pad(tp, ((0, nb * B - N), (0, 0)))
        tb = tp.reshape(nb, B, -1)
        zero = jnp.zeros_like(tb[:1])
        prev = jnp.concatenate([zero, tb[:-1]], axis=0)
        nxt = jnp.concatenate([tb[1:], zero], axis=0)
        kw = dict(precision=self.precision, preferred_element_type=t.dtype)
        out = (
            jnp.einsum("bij,bjm->bim", Wb[:, 0], prev, **kw)
            + jnp.einsum("bij,bjm->bim", Wb[:, 1], tb, **kw)
            + jnp.einsum("bij,bjm->bim", Wb[:, 2], nxt, **kw)
        )
        out = out.reshape(nb * B, -1)[:N].reshape((N,) + rest)
        return jnp.moveaxis(out, 0, ax)

    def apply_bkron(self, um: jnp.ndarray) -> jnp.ndarray:
        """apply_kron with every 1D contraction in block-banded form."""
        dim = self.dim
        if dim == 1:
            return self._bctr(um, self.Kb[0], 0)
        if dim == 2:
            b = self._bctr(um, self.Mb[1], 1)
            a = self._bctr(um, self.Kb[1], 1)
            return self._bctr(b, self.Kb[0], 0) + self._bctr(a, self.Mb[0], 0)
        b = self._bctr(um, self.Mb[2], 2)
        a = self._bctr(um, self.Kb[2], 2)
        mb = self._bctr(b, self.Mb[1], 1)
        kb = self._bctr(b, self.Kb[1], 1)
        ma = self._bctr(a, self.Mb[1], 1)
        return (
            self._bctr(mb, self.Kb[0], 0)
            + self._bctr(kb + ma, self.Mb[0], 0)
        )

    def apply_qbanded(self, um: jnp.ndarray) -> jnp.ndarray:
        """Variable-coefficient apply via global block-banded stages:
        interpolate to the quadrature grid (Bg per axis), per direction d
        apply the block-diagonal collocation derivative, scale by
        c(x_q) * w_q * h^(dim-2), transpose-derivative, then Bg^T per axis.
        Identical arithmetic to apply_local (same quadrature), reordered
        globally — equal to roundoff (tests/test_operator.py)."""
        from . import bblock

        dim = self.dim
        (sB, Rq, Cn), (sBT, _, _), (sD, _, _), (sDT, _, _) = self.qmeta
        v = um
        for ax in range(dim):
            v = bblock.contract(v, self.qBb, sB, Rq, Cn, ax, self.precision)
        nq = self.B.shape[0]
        w = self.qmetric.reshape(
            tuple(1 if a % 2 == 0 else nq for a in range(2 * dim))
        )
        if self.coef is not None:
            shp = []
            for nd in self.n:
                shp.extend((nd, nq))
            wq = (self.coef.reshape(shp) * w).reshape(self.coef.shape)
        else:
            shp = []
            for nd in self.n:
                shp.extend((nd, nq))
            wq = jnp.broadcast_to(w, shp).reshape((Rq,) * dim)
        r = None
        for d in range(dim):
            g = bblock.contract(v, self.qDb, sD, Rq, Rq, d, self.precision)
            g = g * wq
            g = bblock.contract(g, self.qDTb, sDT, Rq, Rq, d, self.precision)
            r = g if r is None else r + g
        for ax in range(dim):
            r = bblock.contract(r, self.qBTb, sBT, Cn, Rq, ax, self.precision)
        return r

    def apply_bilinear(self, um: jnp.ndarray) -> jnp.ndarray:
        """Gather -> element apply -> scatter, WITHOUT the constraint masks.

        The sharded operator wraps this with a halo plane exchange before
        applying the masks (parallel/sharding.py).
        """
        if self.variant == "kron":
            return self.apply_kron(um)
        if self.variant == "bkron":
            return self.apply_bkron(um)
        if self.variant == "qbanded":
            return self.apply_qbanded(um)
        ue = split_all(um, self.dim, self.n, self.degree)
        if self.variant == "dense":
            r = self.apply_local_dense(ue)
        elif self.variant == "qdense":
            r = self.apply_local_qdense(ue)
        else:
            r = self.apply_local(ue)
        return overlap_add_all(r, self.dim, self.n, self.degree)

    def apply(self, u: jnp.ndarray) -> jnp.ndarray:
        """Full vmult with constrained-DoF semantics: A_eff = M A M + (I - M).

        Matches reference vmult incl. copy_constrained_values
        (include/operators/portable_laplace_operator.h:557-719).
        """
        u = u.reshape(self.grid_shape)
        au = self.apply_bilinear(u * self.mask)
        return self.mask * au + (1.0 - self.mask) * u

    # aliases mirroring the reference interface (the operator is symmetric,
    # so Tvmult == vmult; m() == n() == n_dofs — reference:
    # include/base/portable_laplace_operator_base.h:16-60; note `n` the
    # FIELD is cells-per-axis, so the square-size alias is `m` only)
    vmult = apply
    Tvmult = apply

    @property
    def m(self) -> int:
        return self.n_dofs

    def diagonal(self) -> jnp.ndarray:
        return 1.0 / self.inv_diag


def _diagonal_grid(space: FESpace) -> np.ndarray:
    """Matrix diagonal on the DoF grid (NumPy, setup time).

    Exploits the Kronecker-sum structure of the Cartesian element matrix:
    diag(A_loc) is separable, so the assembled diagonal is a sum of dim
    outer products of 1D assembled diagonals.  Constrained DoFs get 1.0,
    mirroring compute_diagonal + constrained handling (reference:
    include/operators/portable_laplace_operator.h:752-917).
    """
    b = make_basis(space.degree)
    W = np.diag(b.q_weights)
    dM = np.diag(b.B.T @ W @ b.B)  # [p+1]
    dK = np.diag(b.D.T @ W @ b.D)
    n = space.mesh.cells_per_axis
    p = space.degree

    def assemble_1d(dloc: np.ndarray) -> np.ndarray:
        N = n * p + 1
        out = np.zeros(N)
        for c in range(n):
            out[c * p : c * p + p + 1] += dloc
        return out

    gM = assemble_1d(dM)
    gK = assemble_1d(dK)
    dim = space.dim
    diag = np.zeros(space.grid_shape)
    for k in range(dim):
        term = np.array(1.0)
        for m in range(dim):
            term = np.multiply.outer(term, gK if m == k else gM)
        diag = diag + term
    diag = diag * space.mesh.h ** (dim - 2)
    m = space.free_mask()
    return diag * m + (1.0 - m)


def diagonal_1d_factors(space: FESpace) -> tuple[np.ndarray, np.ndarray]:
    """Per-axis 1D diagonal factors (gK, gM) with h^(dim-2) folded into gK.

    The grid diagonal is sum_k (x)_d (gK if d==k else gM) — each Kronecker
    term carries exactly one stiffness factor, so the global h power folds
    into gK once (see _diagonal_grid for the assembled-grid twin)."""
    b = make_basis(space.degree)
    W = np.diag(b.q_weights)
    dM = np.diag(b.B.T @ W @ b.B)
    dK = np.diag(b.D.T @ W @ b.D)
    n, p = space.mesh.cells_per_axis, space.degree
    N = n * p + 1
    gM = np.zeros(N)
    gK = np.zeros(N)
    for c in range(n):
        sl = slice(c * p, c * p + p + 1)
        gM[sl] += dM
        gK[sl] += dK
    return gK * space.mesh.h ** (space.dim - 2), gM


def assembled_1d_matrices(space: FESpace) -> tuple[np.ndarray, np.ndarray]:
    """Assembled 1D stiffness/mass matrices on the axis DoF grid (NumPy).

    K1[i,j] = ∫ l_i' l_j' dx,  M1[i,j] = ∫ l_i l_j dx over the 1D mesh, with
    the per-cell (p+1)-point Gauss rule (exact for both integrands)."""
    b = space.basis
    W = np.diag(b.q_weights)
    Kc = (b.D.T @ W @ b.D) / space.mesh.h
    Mc = (b.B.T @ W @ b.B) * space.mesh.h
    n = space.mesh.cells_per_axis
    p = space.degree
    N = space.points_per_axis
    K1 = np.zeros((N, N))
    M1 = np.zeros((N, N))
    for c in range(n):
        sl = slice(c * p, c * p + p + 1)
        K1[sl, sl] += Kc
        M1[sl, sl] += Mc
    return K1, M1


def _global_quad_matrices(space: FESpace) -> tuple[np.ndarray, np.ndarray]:
    """Global per-axis quadrature-stage matrices (NumPy, setup time).

    Bg [n*nq, N]: nodal grid -> quadrature-collocation grid (cell-block-
    diagonal stack of the element interpolation B, overlapping one column
    at shared cell-boundary points).  Dg [n*nq, n*nq]: block-diagonal
    collocation derivative.  Together they hoist the reference's per-cell
    q-point stages to the assembled grid, so Bg^T absorbs the overlap-add
    scatter exactly."""
    b = space.basis
    n = space.mesh.cells_per_axis
    p = space.degree
    nq = b.n_q
    N = space.points_per_axis
    Bg = np.zeros((n * nq, N))
    Dg = np.zeros((n * nq, n * nq))
    for c in range(n):
        Bg[c * nq : (c + 1) * nq, c * p : c * p + p + 1] = b.B
        Dg[c * nq : (c + 1) * nq, c * nq : (c + 1) * nq] = b.Dco
    return Bg, Dg


def _pack_block_tridiagonal(A: np.ndarray, B: int = 128) -> np.ndarray:
    """Repack a banded matrix [N, N] (band halfwidth < B) into block-
    tridiagonal form [nb, 3, B, B]: out[i, k] is the (i, i+k-1) block of the
    zero-padded [nb*B, nb*B] matrix.  Exact repartition — every nonzero
    entry lands in exactly one block, so the block contraction reproduces
    A @ x to roundoff (no assembly/double-counting subtlety: this slices a
    GLOBAL assembled matrix, unlike the block-LOCAL partial assemblies the
    sharded slabs need)."""
    N = A.shape[0]
    nb = -(-N // B)
    Ap = np.zeros((nb * B, nb * B), A.dtype)
    Ap[:N, :N] = A
    out = np.zeros((nb, 3, B, B), A.dtype)
    for i in range(nb):
        rows = slice(i * B, (i + 1) * B)
        for k in range(3):
            j = i + k - 1
            if 0 <= j < nb:
                out[i, k] = Ap[rows, j * B : (j + 1) * B]
    return out


def _grad_matrix(basis, dim: int) -> np.ndarray:
    """Dense element gradient operator [(p+1)^dim, dim*nq^dim] (setup time).

    Column block d maps nodal element DoFs to the d-derivative at all
    quadrature points: kron over axes of (Dco @ B if a == d else B) —
    identical factors to the sum-factorized pipeline's stage 1+2."""
    DB = basis.Dco @ basis.B
    blocks = []
    for d in range(dim):
        G = np.array([[1.0]])
        for a in range(dim):
            G = np.kron(G, DB if a == d else basis.B)
        blocks.append(G)  # [nq^dim, (p+1)^dim]
    return np.concatenate(blocks, axis=0).T


def _coef_at_quad(space: FESpace, coefficient) -> np.ndarray:
    """Sample a coefficient callable at all quadrature points: [n*nq]^dim."""
    from ..fem.assemble import quad_grid_1d

    x1 = quad_grid_1d(space)
    coords = np.meshgrid(*([x1] * space.dim), indexing="ij")
    return np.asarray(coefficient(*coords), dtype=np.float64)


def _diagonal_grid_coef(space: FESpace, coef: np.ndarray) -> np.ndarray:
    """Matrix diagonal for a variable scalar coefficient (NumPy, setup).

    d[i] = sum_q c_q w_q h^(dim-2) |grad phi_i(q)|^2; the squared gradient
    factorizes per axis, so this is a sum-factorized contraction of the
    coefficient grid with squared 1D matrices, followed by overlap-add."""
    from ..fem.assemble import overlap_add_np

    b = make_basis(space.degree)
    p = space.degree
    nq = b.n_q
    n = space.mesh.cells_per_axis
    dim = space.dim
    B2 = b.B**2 * b.q_weights[:, None]
    D2 = b.D**2 * b.q_weights[:, None]
    # B2/D2[q, i] include the quadrature weight for that axis
    diag = np.zeros(space.grid_shape)
    for k in range(dim):
        t = coef
        for ax in range(dim):
            M = D2 if ax == k else B2
            t = np.moveaxis(t, ax, 0)
            shp = t.shape
            t = t.reshape(n, nq, *shp[1:])
            t = np.tensordot(M, t, axes=(0, 1))  # [p+1, n, ...]
            t = np.moveaxis(t, 0, 1)
            t = np.moveaxis(np.moveaxis(t, 1, -1), 0, ax)
            t = overlap_add_np(t, ax, n, p, p + 1)
        diag = diag + t
    diag = diag * space.mesh.h ** (dim - 2)
    m = space.free_mask()
    return diag * m + (1.0 - m)


def best_xla_variant(space: FESpace) -> str:
    """The operator variant ``variant="auto"`` builds for a constant-
    coefficient space: "dense" (one [E, (p+1)^dim] x [(p+1)^dim,
    (p+1)^dim] matmul between a window split and an overlap-add).

    Measured on an H100 (PERF.md, f32 and f64 at "highest"): dense is the
    fastest XLA form at every size swept — 3D Q4 r=6 1.22 ms per apply
    against 2.56 (kron), 5.34 (bkron) and 5.61 (sumfac); 3D Q4 r=7, 3D Q2
    r=7 and the 2D Q7 r=8 p-ladder level likewise — and halves the
    production V-cycle (31.9 against 61.4 ms with kron)."""
    return "dense"


def make_laplace(
    space: FESpace,
    dtype=jnp.float64,
    variant: str = "sumfac",
    coefficient=None,
    precision: str = "highest",
) -> LaplaceOperator:
    """Build the device operator for a space (host-side setup, shipped once).

    variant "sumfac": per-direction 1D contractions (general, low flops);
    variant "dense": one constant element matrix applied as a single
    matmul per batch; variant "kron": assembled 1D matrices applied as
    dim large matmuls on the contiguous grid; variant "bkron": kron with
    the 1D matrices in block-tridiagonal [nb, 3, 128, 128] form — batched
    matmuls at O(384 N) per contraction, the large-N (2D driver) path;
    variant "auto": :func:`best_xla_variant` (constant coefficient) or
    "qdense" (variable coefficient).
    """
    from ..fem.assemble import element_stiffness_cartesian

    b = space.basis
    dim = space.dim
    wq = b.q_weights
    qm = np.array(1.0)
    for _ in range(dim):
        qm = np.multiply.outer(qm, wq)
    qm = qm * space.mesh.h ** (dim - 2)
    coef = None
    inv_diag_full = None
    dK1 = dM1 = None
    Gmat = wcoef_e = None
    qBb = qBTb = qDb = qDTb = None
    qmeta = None
    if coefficient is None and variant == "auto":
        variant = best_xla_variant(space)
    if coefficient is not None:
        if variant in ("auto", "qdense"):
            variant = "qdense"
        elif variant not in ("sumfac", "qbanded"):
            raise ValueError(
                "variable coefficients require the 'sumfac', 'qdense' or "
                "'qbanded' variant"
            )
        coef = _coef_at_quad(space, coefficient)
        # the variable-coefficient diagonal is not separable: store it whole
        inv_diag_full = jnp.asarray(
            1.0 / _diagonal_grid_coef(space, coef), dtype
        )
        if variant == "qdense":
            nq = b.n_q
            n_c = space.mesh.cells_per_axis
            # coefficient grid [n*nq]^dim -> element layout [E, nq^dim],
            # with the (already h-folded) quadrature metric baked in
            shp = []
            for _ in range(dim):
                shp.extend((n_c, nq))
            ce = coef.reshape(shp)
            perm = tuple(range(0, 2 * dim, 2)) + tuple(range(1, 2 * dim, 2))
            ce = ce.transpose(perm).reshape(n_c**dim, nq**dim)
            Gmat = jnp.asarray(_grad_matrix(b, dim), dtype)
            wcoef_e = jnp.asarray(ce * qm.reshape(1, -1), dtype)
            coef = None  # grid-layout copy not needed on the qdense path
        elif variant == "qbanded":
            from . import bblock

            Bg, Dg = _global_quad_matrices(space)
            pB = bblock.pack_rect(Bg)
            pBT = bblock.pack_rect(Bg.T)
            pD = bblock.pack_rect(Dg)
            pDT = bblock.pack_rect(Dg.T)
            qBb = jnp.asarray(pB[0], dtype)
            qBTb = jnp.asarray(pBT[0], dtype)
            qDb = jnp.asarray(pD[0], dtype)
            qDTb = jnp.asarray(pDT[0], dtype)
            qmeta = tuple(p[1:] for p in (pB, pBT, pD, pDT))
    else:
        gK, gM = diagonal_1d_factors(space)
        dK1 = (jnp.asarray(gK, dtype),) * dim
        dM1 = (jnp.asarray(gM, dtype),) * dim
    elem = None
    Kg = Mg = Kb = Mb = None
    if variant == "dense":
        elem = jnp.asarray(
            element_stiffness_cartesian(space.degree, dim, space.mesh.h), dtype
        )
    elif variant == "kron":
        K1, M1 = assembled_1d_matrices(space)
        Kg = (jnp.asarray(K1, dtype),) * dim
        Mg = (jnp.asarray(M1, dtype),) * dim
    elif variant == "bkron":
        K1, M1 = assembled_1d_matrices(space)
        Kb = (jnp.asarray(_pack_block_tridiagonal(K1), dtype),) * dim
        Mb = (jnp.asarray(_pack_block_tridiagonal(M1), dtype),) * dim
    elif variant not in ("sumfac", "qdense", "qbanded"):
        raise ValueError(f"unknown operator variant: {variant!r}")
    return LaplaceOperator(
        dim=dim,
        degree=space.degree,
        n=(space.mesh.cells_per_axis,) * dim,
        variant=variant,
        precision=precision,
        B=jnp.asarray(b.B, dtype),
        Dco=jnp.asarray(b.Dco, dtype),
        qmetric=jnp.asarray(qm, dtype),
        mask1=(jnp.asarray(space.free_mask_1d(), dtype),) * dim,
        dK1=dK1,
        dM1=dM1,
        inv_diag_full=inv_diag_full,
        elem_matrix=elem,
        Kg=Kg,
        Mg=Mg,
        Kb=Kb,
        Mb=Mb,
        coef=None if coef is None else jnp.asarray(coef, dtype),
        Gmat=Gmat,
        wcoef_e=wcoef_e,
        qBb=qBb,
        qBTb=qBTb,
        qDb=qDb,
        qDTb=qDTb,
        qmeta=qmeta,
    )
