"""Solve-time suite on one GPU: five solver configurations, one JSON line each.

Run from the repository root:

    python bench_all.py [--small]

Each configuration is solved twice; the first call compiles and its time is
reported as ``first_solve_s``, the second as ``solve_s``.  Both include the
copy of the solution to the host and the host-side L2 norm, which is how a
user calls ``solve()``.  Every record names the platform, ``device_kind``
and the device count.  Refuses to run without a GPU.
"""

from __future__ import annotations

import argparse
import json
import time


def _time_solve(prob, rtol: float):
    t0 = time.perf_counter()
    prob.solve(rtol=rtol)
    t1 = time.perf_counter()
    _, stats = prob.solve(rtol=rtol)
    return t1 - t0, time.perf_counter() - t1, stats


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true",
                    help="one refinement less per configuration")
    args = ap.parse_args()

    import jax

    from portable_multigrid_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    jax.config.update("jax_enable_x64", True)  # the f64 outer CG of config 5
    dev = jax.devices()
    if dev[0].platform != "gpu":
        raise SystemExit(
            f"bench_all: needs a GPU, JAX found platform {dev[0].platform!r}"
        )
    device = {"platform": dev[0].platform, "device_kind": dev[0].device_kind,
              "device_count": len(dev)}
    import jax.numpy as jnp

    from portable_multigrid_tpu.models.elasticity import ElasticityMultigrid
    from portable_multigrid_tpu.models.mixed import (
        MixedMultigridPoisson,
        MixedPrecisionPoisson,
    )
    from portable_multigrid_tpu.models.poisson import GeometricMultigridPoisson

    shrink = 1 if args.small else 0
    f32 = jnp.float32
    configs = (
        # 3D Q1 geometric V-cycle (degree-1 Chebyshev is damped Jacobi; the
        # default Chebyshev(5) configuration strictly dominates it)
        ("3d_q1_geometric_cg", 1e-5, lambda: GeometricMultigridPoisson(
            3, 1, 6 - shrink, dtype=f32, variant="auto")),
        ("3d_q4_geometric_chebyshev", 1e-5, lambda: GeometricMultigridPoisson(
            3, 4, 5 - shrink, dtype=f32, variant="auto")),
        # polynomial ladder p=4->2->1 handing off to geometric levels
        ("mixed_p421_to_geometric", 1e-5, lambda: MixedMultigridPoisson(
            3, 4 - shrink, p_ladder=(1, 2, 4), dtype=f32, variant="auto")),
        ("elasticity_q3_geometric", 1e-5, lambda: ElasticityMultigrid(
            3, 3, 3 - shrink, dtype=f32)),
        # f32 V-cycle preconditioning f64 CG to 1e-12
        ("mixed_precision_f32mg_f64cg", 1e-12, lambda: MixedPrecisionPoisson(
            3, 2, 4 - shrink, mg_dtype=f32, variant="auto")),
    )
    for name, rtol, build in configs:
        t0 = time.perf_counter()
        prob = build()
        setup_s = time.perf_counter() - t0
        first_s, solve_s, st = _time_solve(prob, rtol)
        print(json.dumps({
            "config": name, "rtol": rtol, "n_dofs": st.n_dofs,
            "iterations": st.iterations, "converged": st.converged,
            "residual": st.residual_norm, "setup_s": setup_s,
            "first_solve_s": first_s, "solve_s": solve_s,
            "dofs_per_s": st.n_dofs / solve_s, **device,
        }), flush=True)


if __name__ == "__main__":
    main()
