"""Vector-valued linear elasticity operator (sum-factorized, JAX/XLA).

The vector-valued linear elasticity operator.  Weak form

    a(u, v) = ∫ 2 mu  eps(u) : eps(v) + lambda (div u)(div v) dx,

on the structured hyper-cube mesh with homogeneous Dirichlet on the whole
boundary.  The reference's q-point stage (reference:
include/operators/portable_laplace_operator.h:300-325) generalizes here to a
full gradient tensor per quadrature point:

  element apply:  for each component c: evaluate collocation gradients
  G[c, d]; stress tau[c, d] = mu (G[c,d] + G[d,c]) + lambda delta_cd tr G
  (scaled by the quadrature/metric weight); integrate back per component.

Vectors are [dim, N, ..., N] arrays (component-major); CG / Chebyshev /
V-cycle operate on them unchanged (shape-agnostic).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..fem.basis import make_basis
from ..fem.space import FESpace
from ..utils.pytree import pytree_dataclass, static_field
from .structured import contract, overlap_add_all, split_all


@pytree_dataclass
class ElasticityOperator:
    """Matrix-free linear elasticity on a structured Q_p space (Cartesian)."""

    dim: int = static_field()
    degree: int = static_field()
    n: tuple = static_field()
    precision: str = static_field(default="highest")
    variant: str = static_field(default="sumfac")  # "sumfac" | "kron" | "dense"
    mu: float = static_field(default=1.0)
    lam: float = static_field(default=1.0)
    B: jnp.ndarray = None
    Dco: jnp.ndarray = None
    qmetric: jnp.ndarray = None  # w ⊗ ... ⊗ w * h^(dim-2)
    mask: jnp.ndarray = None  # scalar grid mask (shared by all components)
    inv_diag: jnp.ndarray = None  # [dim, grid]
    # "kron" variant: assembled global 1D matrices (the elasticity weak form
    # factorizes EXACTLY over the tensor-product mesh, like the scalar
    # apply_kron — ops/laplace.py:208): stiffness K, mass M, and the
    # gradient matrix G1[i,j] = ∫ l_i' l_j dx (test-derivative rows)
    Kg: jnp.ndarray = None
    Mg: jnp.ndarray = None
    Gg: jnp.ndarray = None
    GgT: jnp.ndarray = None  # host-transposed copy (trial-derivative axes)
    # "dense" variant: the constant [dim*(p+1)^dim]^2 element matrix
    # (component-major), applied as ONE matmul over all elements
    elem_matrix: jnp.ndarray = None

    @property
    def grid_shape(self) -> tuple[int, ...]:
        return tuple(nd * self.degree + 1 for nd in self.n)

    @property
    def shape(self) -> tuple[int, ...]:
        return (self.dim,) + self.grid_shape

    @property
    def n_dofs(self) -> int:
        out = self.dim
        for s in self.grid_shape:
            out *= s
        return out

    def apply_kron(self, um: jnp.ndarray) -> jnp.ndarray:
        """Apply via assembled global 1D matrices (Kronecker form).

        Weak-form factorization per test component c (test function e_c φ):

          out_c = mu Σ_a D(∂a, ∂a) u_c + mu Σ_a D(∂a, ∂c) u_a
                  + lam Σ_a D(∂c, ∂a) u_a

        where D(∂e, ∂f) is the scalar trilinear term with the test
        derivative on axis e and the trial derivative on axis f: K on the
        axis if e == f, else G on axis e and Gᵀ on axis f, M elsewhere —
        every term a chain of dim large matmuls on the contiguous DoF
        grid (the matmul reformulation of the reference's q-point
        gradient-tensor loop, portable_laplace_operator.h:300-325)."""
        dim = self.dim
        mu, lam = self.mu, self.lam
        K, M, G, GT = self.Kg, self.Mg, self.Gg, self.GgT

        def ctr(t, W, ax):
            out = jnp.tensordot(t, W, axes=((ax,), (1,)),
                                precision=self.precision)
            return jnp.moveaxis(out, -1, ax)

        def kron(w, mats):
            for ax in reversed(range(dim)):
                w = ctr(w, mats[ax], ax)
            return w

        def pattern(e, f):
            """Per-axis matrices for D(∂e, ∂f), e != f."""
            return tuple(
                G if a == e else GT if a == f else M for a in range(dim)
            )

        outs = []
        for c in range(dim):
            # diagonal block: Σ_a alpha_a D(∂a, ∂a) u_c with
            # alpha_c = 2 mu + lam (the a == c terms of all three sums),
            # alpha_a = mu otherwise
            out = None
            for a in range(dim):
                alpha = 2.0 * mu + lam if a == c else mu
                mats = tuple(K if ax == a else M for ax in range(dim))
                t = alpha * kron(um[c], mats)
                out = t if out is None else out + t
            # mixed blocks (a != c): mu D(∂a, ∂c) u_a + lam D(∂c, ∂a) u_a
            for a in range(dim):
                if a == c:
                    continue
                out = out + mu * kron(um[a], pattern(a, c))
                out = out + lam * kron(um[a], pattern(c, a))
            outs.append(out)
        return jnp.stack(outs)

    def apply_dense(self, um: jnp.ndarray) -> jnp.ndarray:
        """Element apply as ONE matmul with the constant vector-valued
        element matrix.

        On the affine uniformly refined mesh every cell's elasticity element
        matrix is identical, so the whole element loop — including ALL
        component coupling — is a [E, dim*(p+1)^dim] @ [dim*(p+1)^dim]^2
        matmul (the vector-valued twin of the scalar dense variant,
        ops/laplace.py:apply_local_dense).  The kron variant's 21 assembled
        Kronecker chains cost O(N^4) FLOPs per chain (dense global 1D
        matrices); this path is O(E * (dim*ndof)^2) on the systolic array —
        the matmul reformulation of the reference's per-cell q-point
        gradient-tensor loop (reference:
        include/operators/portable_laplace_operator.h:300-325)."""
        dim = self.dim
        q = self.degree + 1
        perm = tuple(range(0, 2 * dim, 2)) + tuple(range(1, 2 * dim, 2))
        inv = [0] * (2 * dim)
        for i, p_ in enumerate(perm):
            inv[p_] = i
        E = 1
        for nd in self.n:
            E *= nd
        flats = [
            split_all(um[c], dim, self.n, self.degree)
            .transpose(perm)
            .reshape(E, q**dim)
            for c in range(dim)
        ]
        flat = jnp.concatenate(flats, axis=1)  # [E, dim*ndof], component-major
        r = jnp.dot(flat, self.elem_matrix, precision=self.precision,
                    preferred_element_type=flat.dtype)
        outs = []
        for c in range(dim):
            t = r[:, c * q**dim:(c + 1) * q**dim].reshape(
                tuple(self.n) + (q,) * dim
            ).transpose(inv)
            outs.append(overlap_add_all(t, dim, self.n, self.degree))
        return jnp.stack(outs)

    def apply_bilinear(self, um: jnp.ndarray) -> jnp.ndarray:
        if self.variant == "kron":
            return self.apply_kron(um)
        if self.variant == "dense":
            return self.apply_dense(um)
        dim, B, Dco = self.dim, self.B, self.Dco
        qaxes = [2 * d + 1 for d in range(dim)]
        w = self.qmetric.reshape(
            tuple(1 if a % 2 == 0 else self.B.shape[0] for a in range(2 * dim))
        )

        # gather + collocation values per component
        vals = []
        for c in range(dim):
            ue = split_all(um[c], dim, self.n, self.degree)
            v = ue
            for ax in qaxes:
                v = contract(v, B, ax, precision=self.precision)
            vals.append(v)

        # gradient tensor G[c][d] at quadrature points
        G = [
            [
                contract(vals[c], Dco, qaxes[d], precision=self.precision)
                for d in range(dim)
            ]
            for c in range(dim)
        ]

        # stress tau[c][d] = mu (G[c,d] + G[d,c]) + lambda delta_cd tr(G)
        trG = G[0][0]
        for d in range(1, dim):
            trG = trG + G[d][d]
        out_components = []
        for c in range(dim):
            r = None
            for d in range(dim):
                tau = self.mu * (G[c][d] + G[d][c])
                if c == d:
                    tau = tau + self.lam * trG
                tau = tau * w
                g = jnp.tensordot(
                    tau, Dco, axes=((qaxes[d],), (0,)), precision=self.precision
                )
                g = jnp.moveaxis(g, -1, qaxes[d])
                r = g if r is None else r + g
            for ax in qaxes:
                r = jnp.tensordot(
                    r, B, axes=((ax,), (0,)), precision=self.precision
                )
                r = jnp.moveaxis(r, -1, ax)
            out_components.append(
                overlap_add_all(r, dim, self.n, self.degree)
            )
        return jnp.stack(out_components)

    def apply(self, u: jnp.ndarray) -> jnp.ndarray:
        u = u.reshape(self.shape)
        m = self.mask[None]
        au = self.apply_bilinear(u * m)
        return m * au + (1.0 - m) * u

    vmult = apply


def element_stiffness_elasticity(
    degree: int, dim: int, h: float, mu: float, lam: float
) -> np.ndarray:
    """Dense elasticity element matrix [(dim*ndof)]^2, component-major
    ((c, i) lexicographic), for golden tests and the diagonal."""
    from ..fem.assemble import gradient_matrices
    from ..fem.basis import gauss_points

    b = make_basis(degree)
    G = gradient_matrices(degree, dim)  # G_d[Q, ndof] reference gradients
    qp, qw = gauss_points(degree + 1)
    wq = np.array([1.0])
    for _ in range(dim):
        wq = np.kron(wq, qw)
    W = wq * h ** (dim - 2)
    ndof = (degree + 1) ** dim
    A = np.zeros((dim, ndof, dim, ndof))
    gradgrad = sum((Gd * W[:, None]).T @ Gd for Gd in G)  # ∫ grad.grad
    for c in range(dim):
        A[c, :, c, :] += mu * gradgrad
        for cp in range(dim):
            # mu ∂_cp phi_i ∂_c phi_j + lam ∂_c phi_i ∂_cp phi_j
            A[c, :, cp, :] += mu * (G[cp] * W[:, None]).T @ G[c]
            A[c, :, cp, :] += lam * (G[c] * W[:, None]).T @ G[cp]
    return A.reshape(dim * ndof, dim * ndof)


def _elasticity_diagonal(space: FESpace, mu: float, lam: float) -> np.ndarray:
    """Assembled diagonal [dim, grid] from the (constant) element matrix."""
    A = element_stiffness_elasticity(
        space.degree, space.dim, space.mesh.h, mu, lam
    )
    d_loc = np.diag(A).reshape(space.dim, -1)
    l2g = space.local_to_global()
    diag = np.zeros((space.dim, space.n_dofs))
    for e in range(l2g.shape[0]):
        for c in range(space.dim):
            np.add.at(diag[c], l2g[e], d_loc[c])
    diag = diag.reshape((space.dim,) + space.grid_shape)
    m = space.free_mask()[None]
    return diag * m + (1.0 - m)


def assembled_1d_gradient(space: FESpace) -> np.ndarray:
    """Assembled 1D gradient matrix on the axis DoF grid (NumPy):
    G1[i,j] = ∫ l_i' l_j dx over the 1D mesh (test-derivative rows; h-free —
    the 1/h of the derivative cancels the h of dx)."""
    b = space.basis
    W = np.diag(b.q_weights)
    Gc = b.D.T @ W @ b.B
    n = space.mesh.cells_per_axis
    p = space.degree
    N = space.points_per_axis
    G1 = np.zeros((N, N))
    for c in range(n):
        sl = slice(c * p, c * p + p + 1)
        G1[sl, sl] += Gc
    return G1


def make_elasticity(
    space: FESpace, dtype=jnp.float64, mu: float = 1.0, lam: float = 1.0,
    variant: str = "sumfac", precision: str = "highest",
) -> ElasticityOperator:
    b = space.basis
    dim = space.dim
    qm = np.array(1.0)
    for _ in range(dim):
        qm = np.multiply.outer(qm, b.q_weights)
    qm = qm * space.mesh.h ** (dim - 2)
    diag = _elasticity_diagonal(space, mu, lam)
    Kg = Mg = Gg = GgT = elem = None
    if variant == "dense":
        elem = jnp.asarray(
            element_stiffness_elasticity(
                space.degree, space.dim, space.mesh.h, mu, lam
            ),
            dtype,
        )
    if variant == "kron":
        from .laplace import assembled_1d_matrices

        K1, M1 = assembled_1d_matrices(space)
        G1 = assembled_1d_gradient(space)
        Kg = jnp.asarray(K1, dtype)
        Mg = jnp.asarray(M1, dtype)
        Gg = jnp.asarray(G1, dtype)
        GgT = jnp.asarray(G1.T, dtype)
    return ElasticityOperator(
        dim=dim,
        degree=space.degree,
        n=(space.mesh.cells_per_axis,) * dim,
        precision=precision,
        variant=variant,
        mu=float(mu),
        lam=float(lam),
        B=jnp.asarray(b.B, dtype),
        Dco=jnp.asarray(b.Dco, dtype),
        qmetric=jnp.asarray(qm, dtype),
        mask=jnp.asarray(space.free_mask(), dtype),
        inv_diag=jnp.asarray(1.0 / diag, dtype),
        Kg=Kg,
        Mg=Mg,
        Gg=Gg,
        GgT=GgT,
        elem_matrix=elem,
    )


def dense_elasticity_operator(
    space: FESpace, mu: float = 1.0, lam: float = 1.0
) -> np.ndarray:
    """Dense golden elasticity operator with constrained-DoF semantics,
    component-major global ordering ((c, dof) lexicographic)."""
    A_loc = element_stiffness_elasticity(
        space.degree, space.dim, space.mesh.h, mu, lam
    )
    dim = space.dim
    nd = space.n_dofs
    ndof = (space.degree + 1) ** space.dim
    l2g = space.local_to_global()
    N = dim * nd
    A = np.zeros((N, N))
    for e in range(l2g.shape[0]):
        idx = np.concatenate([c * nd + l2g[e] for c in range(dim)])
        A[np.ix_(idx, idx)] += A_loc.reshape(dim, ndof, dim, ndof).transpose(
            0, 1, 2, 3
        ).reshape(dim * ndof, dim * ndof)
    m = np.tile(space.free_mask().reshape(-1), dim)
    A = A * m[:, None] * m[None, :]
    A[np.arange(N), np.arange(N)] += 1.0 - m
    return A
