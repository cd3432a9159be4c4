"""Chebyshev smoother with CG-Lanczos eigenvalue estimation.

JAX replacement for deal.II's ``PreconditionChebyshev`` exactly as the
reference configures it (reference: source/geometric_multigrid/program.cc:259-287):

  * smoothing levels: smoothing_range 15, polynomial degree 5,
    10 CG iterations for the eigenvalue estimate;
  * coarsest level, "Chebyshev as solver": smoothing_range 1e-3, adaptive
    degree, eig_cg_n_iterations = m() (reference:
    source/geometric_multigrid/program.cc:274-279 and the comment at
    include/multigrid/portable_v_cycle_multigrid.h:150-151).

The eigenvalue-bound and adaptive-degree rules follow the published deal.II
algorithm (documented in the deal.II manual for PreconditionChebyshev):

  beta  = 1.2 * max_eigenvalue_estimate
  alpha = max_eig / smoothing_range              if smoothing_range > 1
        = min(0.9 * max_eig, min_eig_estimate)   otherwise
  adaptive degree = 1 + log(1/eps + sqrt(1/eps^2 - 1)) / log(1/sigma),
      sigma = (1 - sqrt(alpha/beta)) / (1 + sqrt(alpha/beta)), eps = range.

The eigenvalue estimate runs preconditioned CG and takes the extreme
eigenvalues of the Lanczos tridiagonal built from the CG coefficients
(alpha_k, beta_k):  T_kk = 1/alpha_k + beta_{k-1}/alpha_{k-1},
T_{k,k+1} = sqrt(beta_k)/alpha_k.  Deviation from deal.II: the initial vector
is a deterministic hash-based pseudo-random vector restricted to free DoFs
(deal.II uses its own deterministic "high-frequency" fill); both choices give
Lanczos estimates of the same extreme eigenvalues.

The smoother application is the standard three-term Chebyshev recurrence
(Saad, "Iterative Methods for Sparse Linear Systems", Alg. 12.1) applied to
the Jacobi-preconditioned operator; polynomial degree d costs d-1 operator
applications plus d diagonal scalings, matching deal.II's cost model
("degree 1 = damped Jacobi").
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..utils.pytree import pytree_dataclass, static_field

_HI = jax.lax.Precision.HIGHEST


@pytree_dataclass
class Chebyshev:
    """Chebyshev polynomial preconditioner/smoother of a fixed degree.

    ``op`` is any pytree with an ``apply`` method (the level operator);
    ``inv_diag`` is the inverse matrix diagonal (the Jacobi preconditioner,
    reference: source/geometric_multigrid/program.cc:281-283).
    """

    degree: int = static_field()
    op: object = None
    # None = derive from op.inv_diag at trace time (keeps huge grids out of
    # the smoother pytree; the operator stores separable 1D factors)
    inv_diag: jnp.ndarray = None
    theta: jnp.ndarray = None  # (beta + alpha) / 2
    delta: jnp.ndarray = None  # (beta - alpha) / 2

    def apply(self, b: jnp.ndarray) -> jnp.ndarray:
        """Return p(P^-1 A) P^-1 b — the preconditioner vmult with x0 = 0."""
        inv_diag = self.inv_diag if self.inv_diag is not None else self.op.inv_diag
        sigma1 = self.theta / self.delta
        rho = 1.0 / sigma1
        d = (inv_diag * b) / self.theta
        x = d
        r = b
        for _ in range(1, self.degree):
            r = r - self.op.apply(d)
            rho_new = 1.0 / (2.0 * sigma1 - rho)
            d = (rho_new * rho) * d + (2.0 * rho_new / self.delta) * (
                inv_diag * r
            )
            x = x + d
            rho = rho_new
        return x


def _pseudo_random_grid(shape, dtype) -> np.ndarray:
    rng = np.random.default_rng(42)
    return rng.uniform(-0.5, 0.5, size=shape).astype(np.float64)


def _host_free_mask(op) -> np.ndarray | None:
    """Host-side free-DoF mask for the eigenvalue start vector.

    Prefers the operator's separable 1D factors (tiny device reads) over
    materializing + reading back the full grid mask."""
    m1 = getattr(op, "mask1", None)
    if m1 is not None:
        m = np.asarray(m1[0], dtype=np.float64)
        for f in m1[1:]:
            m = np.multiply.outer(m, np.asarray(f, dtype=np.float64))
        return m
    m = getattr(op, "mask", None)
    return None if m is None else np.asarray(m, dtype=np.float64)


def estimate_eigenvalues(
    op, inv_diag: jnp.ndarray | None, n_iter: int, v0: jnp.ndarray
) -> tuple[float, float]:
    """Extreme eigenvalues of P^-1 A via n_iter CG-Lanczos iterations.

    ``inv_diag=None`` derives the Jacobi preconditioner from ``op.inv_diag``
    inside the traced program (no large captured constants).  The operator
    pytree is a jit ARGUMENT (like models/poisson.py:_solve), not a closure:
    kron operators on large grids carry dense 1D matrices (a 2D Q7 r=9
    level is 2 x 51 MB), and closure capture would embed them as HLO
    constants in every per-level setup compile.  Inner products run at
    HIGHEST precision (an f32 dot may otherwise round its operands)."""
    n_iter = int(n_iter)

    @jax.jit
    def run(op, inv_diag, b):
        idg = op.inv_diag if inv_diag is None else inv_diag
        r = b
        x = jnp.zeros_like(b)
        z = idg * r
        rz = jnp.vdot(r, z, precision=_HI)

        def step(carry, _):
            x, r, p, rz, stop = carry
            Ap = op.apply(p)
            pAp = jnp.vdot(p, Ap, precision=_HI)
            bad = jnp.logical_or(stop, pAp <= 0.0)
            alpha = jnp.where(bad, jnp.inf, rz / jnp.where(pAp == 0, 1.0, pAp))
            x = x + jnp.where(bad, 0.0, alpha) * p
            r = r - jnp.where(bad, 0.0, alpha) * Ap
            z = idg * r
            rz_new = jnp.vdot(r, z, precision=_HI)
            beta = jnp.where(bad, 0.0, rz_new / jnp.where(rz == 0, 1.0, rz))
            p = z + beta * p
            stop = jnp.logical_or(bad, rz_new <= 1e-300)
            return (x, r, p, rz_new, stop), (alpha, beta)

        _, (alphas, betas) = jax.lax.scan(
            step, (x, r, z, rz, jnp.bool_(False)), None, length=n_iter
        )
        return alphas, betas

    alphas_dev, betas_dev = run(op, inv_diag, v0)
    alphas = np.asarray(alphas_dev, dtype=np.float64)
    betas = np.asarray(betas_dev, dtype=np.float64)
    valid = np.isfinite(alphas) & (alphas != 0) & np.isfinite(betas)
    k = int(np.sum(np.cumprod(valid)))  # leading run of valid steps
    if k == 0:
        return 1.0, 1.0
    a = alphas[:k]
    b = betas[:k]
    diag = 1.0 / a
    diag[1:] += b[:-1] / a[:-1]
    off = np.sqrt(np.maximum(b[:-1], 0.0)) / a[:-1]
    T = np.diag(diag)
    if k > 1:
        T += np.diag(off, 1) + np.diag(off, -1)
    ev = np.linalg.eigvalsh(T)
    if not (np.isfinite(ev[0]) and np.isfinite(ev[-1]) and ev[-1] > 0):
        # long low-precision CG runs can break down past convergence;
        # degenerate estimates fall back to the safe unit interval
        return 1.0, 1.0
    return float(ev[0]), float(ev[-1])


def chebyshev_bounds(
    min_eig: float, max_eig: float, smoothing_range: float, degree: int | None
) -> tuple[float, float, int]:
    """deal.II's interval/degree rules (see module docstring). Returns
    (alpha, beta, degree)."""
    beta = 1.2 * max_eig
    if smoothing_range > 1.0:
        alpha = max_eig / smoothing_range
    else:
        alpha = min(0.9 * max_eig, min_eig)
    # keep the interval non-degenerate on BOTH ends: low-precision Lanczos
    # breakdown can report min_eig ~ 0, which would blow the adaptive
    # degree below (the Jacobi-preconditioned operator's true condition
    # number is far under 1e6 for every configuration here)
    alpha = max(alpha, beta * 1e-6)
    alpha = min(alpha, beta * (1.0 - 1e-8))
    if degree is None:
        actual_range = beta / alpha
        sigma = (1.0 - np.sqrt(1.0 / actual_range)) / (
            1.0 + np.sqrt(1.0 / actual_range)
        )
        eps = smoothing_range
        degree = int(
            1
            + np.log(1.0 / eps + np.sqrt(1.0 / eps**2 - 1.0))
            / np.log(1.0 / max(sigma, 1e-12))
        )
        # sanity cap: a degenerate eigenvalue estimate (low-precision CG
        # breakdown can report min_eig ~ 0) would otherwise request an
        # astronomically unrolled recurrence; every legitimate coarse-solver
        # degree in this framework is far below this bound
        degree = min(max(degree, 1), 512)
    return float(alpha), float(beta), int(degree)


def make_chebyshev(
    op,
    *,
    smoothing_range: float = 15.0,
    degree: int | None = 5,
    eig_cg_n_iterations: int = 10,
    inv_diag: jnp.ndarray | None = None,
    free_mask: jnp.ndarray | None = None,
) -> Chebyshev:
    """Set up the smoother for a level operator (host-side; runs eig-CG on device).

    Defaults mirror the reference smoothing levels; pass
    ``smoothing_range=1e-3, degree=None, eig_cg_n_iterations=op.n_dofs`` for
    the coarse-level Chebyshev-as-solver configuration (reference:
    source/geometric_multigrid/program.cc:267-279).
    """
    if inv_diag is not None:
        shape, dtype = inv_diag.shape, inv_diag.dtype
    else:
        # derive shape/dtype without materializing op.inv_diag (it may be a
        # lazily computed O(N^dim) product of separable factors)
        shape = getattr(op, "shape", None) or getattr(op, "grid_shape", None)
        if shape is None:
            shape, dtype = op.inv_diag.shape, op.inv_diag.dtype
        else:
            dtype = op.dtype if hasattr(op, "dtype") else op.inv_diag.dtype
    if int(np.prod(shape)) > 2**25:
        # huge grids: generate the start vector on device instead of
        # building and uploading it from the host; any free-DoF-supported
        # start vector yields the same Lanczos extremes
        v0_dev = jax.random.uniform(
            jax.random.PRNGKey(42), shape, dtype, -0.5, 0.5
        )
        if free_mask is not None:
            v0_dev = v0_dev * jnp.asarray(free_mask, dtype)
        elif getattr(op, "mask1", None) is not None:
            for d, f in enumerate(op.mask1):
                shp = [1] * len(shape)
                shp[d] = f.shape[0]
                v0_dev = v0_dev * f.reshape(shp)
        elif getattr(op, "mask", None) is not None:
            v0_dev = v0_dev * op.mask
    else:
        v0 = _pseudo_random_grid(shape, dtype)
        if free_mask is not None:
            v0 = v0 * np.asarray(free_mask, dtype=np.float64)
        else:
            m = _host_free_mask(op)
            if m is not None:
                v0 = v0 * m
        v0_dev = jnp.asarray(v0, dtype)
    # Cap the Lanczos length: "eig iterations = m()" (the reference's
    # Chebyshev-as-solver coarse config) is an UPPER bound — deal.II's
    # SolverCG stops at convergence, and the extreme-eigenvalue estimates
    # stabilize after tens of iterations.  Without a cap, a LARGE coarse
    # level (the 2D p-ladder's Q1 level: 263k DoFs at r=9) requests a
    # 263k-step device scan AND a (263k)^2 host tridiagonal (np.diag
    # MemoryError).  256 leaves every golden-table
    # configuration untouched (all golden coarse levels are < 256 DoFs).
    import os

    cap = int(os.environ.get("PMG_EIG_MAX_ITERS", "256"))
    n_iter = max(1, min(int(eig_cg_n_iterations), int(np.prod(shape)), cap))
    min_eig, max_eig = estimate_eigenvalues(op, inv_diag, n_iter, v0_dev)
    alpha, beta, deg = chebyshev_bounds(min_eig, max_eig, smoothing_range, degree)
    theta = jnp.asarray((beta + alpha) / 2.0, dtype)
    delta = jnp.asarray((beta - alpha) / 2.0, dtype)
    return Chebyshev(
        degree=deg,
        op=op,
        inv_diag=inv_diag,
        theta=theta,
        delta=delta,
    )
