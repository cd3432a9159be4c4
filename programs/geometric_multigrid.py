"""Geometric-multigrid driver: the JAX twin of the reference's first
application (reference: source/geometric_multigrid/program.cc).

3D Poisson on the unit cube, f ≡ 1, homogeneous Dirichlet everywhere,
h-multigrid V(2,2) with Chebyshev(5) smoothing, CG to 1e-12 * ||b||.
Sweeps fe_degree = 1..max_degree and refinement cycles, printing DoF counts,
CG iteration counts and solution L2 norms exactly like the reference
(reference: source/geometric_multigrid/program.cc:189-199,354-355,395).

Usage:
  python programs/geometric_multigrid.py [--dim 3] [--max-degree 7]
         [--cycles N] [--variant kron] [--f32] [--vtu] [--sharded]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dim", type=int, default=3)
    ap.add_argument("--max-degree", type=int, default=7)
    ap.add_argument("--cycles", type=int, default=None,
                    help="refinement cycles (default: 9 - dim, as the reference)")
    ap.add_argument("--variant", default="auto",
                    choices=["sumfac", "dense", "kron", "bkron", "auto"],
                    help="operator variant (default: auto, the production "
                         "choice of ops/laplace.py:best_xla_variant)")
    ap.add_argument("--f32", action="store_true",
                    help="solve in float32 (default float64)")
    ap.add_argument("--rtol", type=float, default=None)
    ap.add_argument("--vtu", action="store_true", help="write solution .vti files")
    ap.add_argument("--sharded", action="store_true",
                    help="shard the solve over all available devices")
    args = ap.parse_args()

    import jax

    from portable_multigrid_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if not args.f32:
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np

    dtype = jnp.float32 if args.f32 else jnp.float64
    rtol = args.rtol if args.rtol is not None else (1e-5 if args.f32 else 1e-12)
    cycles = args.cycles if args.cycles is not None else 9 - args.dim

    from portable_multigrid_tpu.models.poisson import GeometricMultigridPoisson
    from portable_multigrid_tpu.parallel.poisson import ShardedGeometricPoisson

    for degree in range(1, args.max_degree + 1):
        print(f"============== fe_degree = {degree} ============== \n")
        for cycle in range(cycles):
            print(f"\nCycle {cycle}")
            refinements = (3 - args.dim if args.dim < 3 else 0) + cycle + 1
            t0 = time.time()
            if args.sharded:
                prob = ShardedGeometricPoisson(
                    args.dim, degree, refinements, dtype=dtype
                )
            else:
                prob = GeometricMultigridPoisson(
                    args.dim, degree, refinements, dtype=dtype,
                    variant=args.variant,
                )
            x, stats = prob.solve(rtol=rtol, verbose=True)
            print(f"  (wall: {time.time() - t0:.2f}s)")
            if args.vtu:
                from portable_multigrid_tpu.utils.vtu import write_vti

                write_vti(
                    f"solution_p{degree}_c{cycle}.vti",
                    prob.spaces[-1],
                    {"solution": np.asarray(x, dtype=np.float64)},
                )
            print()


if __name__ == "__main__":
    main()
