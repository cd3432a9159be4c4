"""Unstructured-mesh multigrid driver.

h-multigrid Poisson on a fully unstructured (perturbed) hex/quad mesh:
native orientation-matched DoF enumeration, indexed matrix-free operators,
per-cell embedding transfers — the capability layer the reference inherits
from deal.II but never exercises (its drivers run cubes only; reference:
source/geometric_multigrid/program.cc:409-417).

Usage:
  python programs/unstructured_multigrid.py [--dim 3] [--degree 2]
         [--refinements 2] [--base-cells 2] [--amplitude 0.15]
         [--rtol 1e-12] [--vtu out.vtu]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dim", type=int, default=3)
    ap.add_argument("--degree", type=int, default=2)
    ap.add_argument("--refinements", type=int, default=2)
    ap.add_argument("--base-cells", type=int, default=2)
    ap.add_argument("--amplitude", type=float, default=0.15)
    ap.add_argument("--rtol", type=float, default=1e-12)
    ap.add_argument("--vtu", default=None)
    args = ap.parse_args()

    import jax

    from portable_multigrid_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    # the reference solves in double to 1e-12 * ||b||
    jax.config.update("jax_enable_x64", True)

    from portable_multigrid_tpu.fem.general_mesh import perturbed_cube_mesh
    from portable_multigrid_tpu.models.general_geometry import (
        UnstructuredMultigrid,
    )

    gm = perturbed_cube_mesh(args.dim, args.base_cells, args.amplitude)
    t0 = time.time()
    prob = UnstructuredMultigrid(gm, args.degree, args.refinements)
    print(f"setup: {time.time() - t0:.2f} s")
    t0 = time.time()
    x, st = prob.solve(rtol=args.rtol, verbose=True)
    print(f"solve: {time.time() - t0:.2f} s")
    if args.vtu:
        prob.output_vtu(args.vtu, x)
        print(f"wrote {args.vtu}")


if __name__ == "__main__":
    main()
