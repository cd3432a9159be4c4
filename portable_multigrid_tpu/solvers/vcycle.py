"""V-cycle multigrid preconditioner (unrolled over static levels under jit).

JAX rebuild of ``Portable::VCycleMultigrid`` (reference:
include/multigrid/portable_v_cycle_multigrid.h:26-190), preserving its exact
algorithmic structure so the convergence history matches:

  * vmult zero-initialises and recurses from the finest level (:79-94);
  * smooth(u, rhs) = u + Cheb(rhs - A u)  — a full residual per smoothing
    step (:96-126);
  * coarsest level: a single smooth with the Chebyshev-as-solver smoother
    (:148-154);
  * otherwise: pre-smooth xN, residual, restrict, recurse, prolongate_and_add,
    post-smooth xN (:156-188).

Unlike the reference, which allocates five fresh vectors per level per cycle
(SURVEY.md §3.4), everything here is functional: XLA's buffer assignment
reuses memory across the unrolled cycle.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..utils.pytree import pytree_dataclass, static_field


@pytree_dataclass
class MGLevel:
    """One level: operator, smoother, and the transfer to/from the next
    coarser level (None on the coarsest)."""

    op: object = None
    smoother: object = None
    transfer: object = None  # coarser <-> this level


@pytree_dataclass
class VCycle:
    """Multigrid V-cycle preconditioner: levels[0] is the coarsest."""

    pre_smoothing_steps: int = static_field(default=2)
    post_smoothing_steps: int = static_field(default=2)
    levels: tuple = ()

    def _smooth(self, level: int, u: jnp.ndarray, rhs: jnp.ndarray) -> jnp.ndarray:
        lvl = self.levels[level]
        r = rhs - lvl.op.apply(u)
        return u + lvl.smoother.apply(r)

    def _cycle(self, level: int, src: jnp.ndarray) -> jnp.ndarray:
        lvl = self.levels[level]
        if level == 0:
            # coarse "solve" = one Chebyshev-as-solver smooth from zero
            return lvl.smoother.apply(src)
        # first pre-smooth acts on the zero initial guess: r = src - A*0 =
        # src, so the residual apply is skipped (exact; the reference pays
        # this apply, see portable_v_cycle_multigrid.h:120 with u = 0)
        u = lvl.smoother.apply(src)
        for _ in range(self.pre_smoothing_steps - 1):
            u = self._smooth(level, u, src)
        residual = src - lvl.op.apply(u)
        coarse_residual = lvl.transfer.restrict(residual)
        coarse_correction = self._cycle(level - 1, coarse_residual)
        u = lvl.transfer.prolongate_and_add(u, coarse_correction)
        for _ in range(self.post_smoothing_steps):
            u = self._smooth(level, u, src)
        return u

    def apply(self, src: jnp.ndarray) -> jnp.ndarray:
        """Preconditioner vmult: dst = V-cycle(0, src) from the finest level."""
        return self._cycle(len(self.levels) - 1, src)
