"""Polynomial-multigrid driver: the JAX twin of the reference's second
application (reference: source/polynomial_multigrid/program.cc).

2D Poisson on the unit square, single mesh, polynomial ladder
p_l = fe_degree - (mg_levels - 1 - l) (reference: :149-159), V(2,2),
CG to 1e-12 * ||b||; refinement cycles like the reference (:407,439-443).

Usage:
  python programs/polynomial_multigrid.py [--dim 2] [--degree 7]
         [--levels 7] [--cycles 7] [--f32]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dim", type=int, default=2)
    ap.add_argument("--degree", type=int, default=7)
    ap.add_argument("--levels", type=int, default=7)
    ap.add_argument("--cycles", type=int, default=7)
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--rtol", type=float, default=None)
    ap.add_argument("--variant", default="auto",
                    choices=["sumfac", "dense", "kron", "bkron", "auto"],
                    help="operator variant (default: auto, the production "
                         "choice of ops/laplace.py:best_xla_variant)")
    args = ap.parse_args()

    import jax

    from portable_multigrid_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if not args.f32:
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    dtype = jnp.float32 if args.f32 else jnp.float64
    rtol = args.rtol if args.rtol is not None else (1e-5 if args.f32 else 1e-12)

    from portable_multigrid_tpu.models.poisson import PolynomialMultigridPoisson

    print(
        f"============== fe_degree = {args.degree}, "
        f"mg_levels = {args.levels} ==============\n"
    )
    for cycle in range(args.cycles):
        print(f"\nCycle {cycle}")
        refinements = (3 - args.dim) + cycle  # reference: refine(3-dim) + 1/cycle
        t0 = time.time()
        prob = PolynomialMultigridPoisson(
            args.dim, args.degree, refinements, args.levels, dtype=dtype,
            variant=args.variant,
        )
        x, stats = prob.solve(rtol=rtol, verbose=True)
        print(f"  (wall: {time.time() - t0:.2f}s)\n")


if __name__ == "__main__":
    main()
