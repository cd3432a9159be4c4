"""Smoke test of the solver's main path on the GPU.

Run from the repository root:

    python chip_smoke.py          # one card: phases 0-5 below
    python chip_smoke.py --four   # four cards: the sharded solves only

One process drives every card; the only children are ``nvidia-smi`` and the
g++ build of the native setup library, neither of which touches a card.
Every phase checks its own result and any failure ends the run with a
non-zero exit code: no phase catches its own failure and carries on.

Single card:
  0. device: refuses anything but ``platform == "gpu"``; prints the card,
     ``nvidia-smi``'s name and power limit, versions and the compile cache;
  1. reference driver 1 at its largest size in f64 — 3D Poisson Q4 r=6
     (16,974,593 DoF), V(2,2), Chebyshev(5, range 15), CG to 1e-12 ||b||,
     production operator variant — plus Q4 r=3 against its golden row;
  2. the same problem in f32 at the production precision to rtol 1e-5:
     its CG count must equal the f64 count at rtol 1e-5;
  3. reference driver 2 — 2D Q7 r=8 p-ladder (3,214,849 DoF) in f64;
  4. per-role parity at Q4 r=6: production f32 operator and h-transfer
     pair against the f64 references (and the TF32 error, printed);
  5. peak device memory.

``--four``: the 1D-slab and (2, 2)-pencil sharded f64 solves of Q4 r=6,
each against the single-card solve in the same process.

The last line of standard output is the result object
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``;
it is printed only when every phase passed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

from portable_multigrid_tpu.fem.mesh import HyperCubeMesh
from portable_multigrid_tpu.fem.space import FESpace
from portable_multigrid_tpu.models.poisson import (
    GeometricMultigridPoisson,
    PolynomialMultigridPoisson,
)
from portable_multigrid_tpu.ops.laplace import best_xla_variant, make_laplace
from portable_multigrid_tpu.ops.transfer import make_h_transfer
from portable_multigrid_tpu.utils.compile_cache import enable_compile_cache

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden_convergence.json")

# production precision of every f32 contraction (ops/laplace.py)
PRODUCTION_PRECISION = "highest"
# f32 rounding over a (2p+1)-band sum per axis: max-norm relative error of
# an f32 apply against its f64 reference
PARITY_RTOL = 1e-5
# the largest sizes of the reference's two drivers
FULL_SIZES = {"geo_refinements": 6, "golden_refinements": 3,
              "poly_refinements": 8, "parity_refinements": 6}
SHARD_REFINEMENTS = 6


class SmokeFailure(RuntimeError):
    """A phase's result is wrong."""


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def require_gpu(devices, count: int) -> None:
    """Refuse to run anywhere but on ``count`` GPUs (no CPU fallback)."""
    platform = devices[0].platform
    if platform != "gpu":
        raise SystemExit(
            f"chip_smoke: needs a GPU, JAX found platform {platform!r}"
        )
    if len(devices) < count:
        raise SystemExit(
            f"chip_smoke: needs {count} GPUs, JAX found {len(devices)}"
        )


def result_line(devices) -> str:
    """The result object, printed as the last line of a passing run."""
    return json.dumps({
        "ok": True,
        "device": {
            "platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices),
        },
    })


def card_name_and_power() -> str:
    """``nvidia-smi``'s name and power limit of every card (a child that
    stays off JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def golden_rows() -> dict:
    with open(GOLDEN) as f:
        return json.load(f)


def golden_geometric(degree: int, refinements: int) -> dict:
    for row in golden_rows()["geometric_3d"]:
        if (row["degree"], row["refinements"]) == (degree, refinements):
            return row
    raise KeyError((degree, refinements))


def converged_norm(table: str) -> float:
    """The table's best approximation of the exact solution's L2 norm:
    the highest-degree row on the finest mesh."""
    rows = golden_rows()[table]
    best = max(rows, key=lambda r: (r["degree"], r["n_dofs"]))
    return float(best["l2_norm"])


def check_golden_row(stats, row: dict) -> None:
    """The repo's rule for golden rows: equal iterations, L2 to 1e-10."""
    check(stats.converged, f"not converged: {stats}")
    check(stats.n_dofs == row["n_dofs"],
          f"n_dofs {stats.n_dofs} != golden {row['n_dofs']}")
    check(stats.iterations == row["iterations"],
          f"iterations {stats.iterations} != golden {row['iterations']}")
    rel = abs(stats.solution_l2_norm - row["l2_norm"]) / row["l2_norm"]
    check(rel <= 1e-10, f"L2 {stats.solution_l2_norm!r} vs golden "
          f"{row['l2_norm']!r}: rel {rel:.3e} > 1e-10")


def check_norm(norm: float, ref: float, rtol: float, what: str) -> float:
    rel = abs(norm - ref) / abs(ref)
    check(rel <= rtol, f"{what}: L2 {norm!r} vs {ref!r}: rel {rel:.3e} > "
          f"{rtol:g}")
    return rel


def max_rel_error(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def timed_solve(prob, rtol: float):
    """Solve twice: the first call compiles, the second is timed alone.
    Both times include the copy of the solution to the host and the host
    L2 norm."""
    t0 = time.perf_counter()
    prob.solve(rtol=rtol)
    t1 = time.perf_counter()
    x, st = prob.solve(rtol=rtol)
    t2 = time.perf_counter()
    return x, st, t1 - t0, t2 - t1


def say(msg: str) -> None:
    print(msg, flush=True)


def phase_geometric(sizes: dict, card: str) -> int:
    """Phases 1 and 2; returns the f64 CG count at rtol 1e-5."""
    r_gold = sizes["golden_refinements"]
    row = golden_geometric(4, r_gold)
    prob = GeometricMultigridPoisson(3, 4, r_gold, dtype=jnp.float64,
                                     variant="auto")
    _, st = prob.solve(rtol=1e-12)
    check_golden_row(st, row)
    say(f"phase 1: Q4 r={r_gold} f64: {st.iterations} iterations (golden "
        f"{row['iterations']}), L2 {st.solution_l2_norm!r} (golden "
        f"{row['l2_norm']!r})")

    r = sizes["geo_refinements"]
    t0 = time.perf_counter()
    prob = GeometricMultigridPoisson(3, 4, r, dtype=jnp.float64,
                                     variant="auto")
    setup = time.perf_counter() - t0
    _, st, first, solve = timed_solve(prob, 1e-12)
    check(st.converged, f"Q4 r={r} f64 did not converge: {st}")
    check(st.iterations <= 6, f"Q4 r={r} f64: {st.iterations} > 6 iterations")
    ref = converged_norm("geometric_3d")
    rel = check_norm(st.solution_l2_norm, ref, 1e-7, f"Q4 r={r} f64")
    say(f"phase 1: Q4 r={r} f64 ({st.n_dofs} DoF, variant "
        f"{prob.levels[-1].op.variant}): {st.iterations} iterations, "
        f"residual {st.residual_norm:.3e}, L2 {st.solution_l2_norm!r} "
        f"(converged {ref!r}, rel {rel:.2e})")
    say(f"phase 1 timing on {card}: setup {setup:.2f} s (levels + eig-CG), "
        f"first solve {first:.2f} s (incl. compile), solve {solve:.3f} s")
    _, st5 = prob.solve(rtol=1e-5)
    check(st5.converged, f"Q4 r={r} f64 rtol 1e-5 did not converge")
    del prob

    t0 = time.perf_counter()
    prob = GeometricMultigridPoisson(3, 4, r, dtype=jnp.float32,
                                     variant="auto")
    setup = time.perf_counter() - t0
    precisions = {lvl.op.precision for lvl in prob.levels}
    check(precisions == {PRODUCTION_PRECISION},
          f"f32 hierarchy precisions {precisions}")
    _, st32, first, solve = timed_solve(prob, 1e-5)
    check(st32.converged, f"Q4 r={r} f32 did not converge: {st32}")
    check(st32.iterations == st5.iterations,
          f"f32 CG count {st32.iterations} != f64 count {st5.iterations} "
          "at rtol 1e-5")
    say(f"phase 2: Q4 r={r} f32 precision {PRODUCTION_PRECISION}: "
        f"{st32.iterations} iterations at rtol 1e-5 (f64: {st5.iterations})")
    say(f"phase 2 timing on {card}: setup {setup:.2f} s, first solve "
        f"{first:.2f} s (incl. compile), solve {solve:.3f} s")
    return st5.iterations


def phase_polynomial(sizes: dict, card: str) -> None:
    """Phase 3: the 2D Q7 p-ladder."""
    r = sizes["poly_refinements"]
    t0 = time.perf_counter()
    prob = PolynomialMultigridPoisson(2, 7, r, n_levels=7, dtype=jnp.float64,
                                      variant="auto")
    setup = time.perf_counter() - t0
    _, st, first, solve = timed_solve(prob, 1e-12)
    max_iters = max(row["iterations"] for row in golden_rows()["polynomial_2d"])
    check(st.converged, f"2D Q7 r={r} did not converge: {st}")
    check(st.iterations <= max_iters + 1,
          f"2D Q7 r={r}: {st.iterations} > {max_iters + 1} iterations")
    ref = converged_norm("polynomial_2d")
    rel = check_norm(st.solution_l2_norm, ref, 1e-7, f"2D Q7 r={r}")
    variants = [lvl.op.variant for lvl in prob.levels]
    say(f"phase 3: 2D Q7 r={r} p-ladder f64 ({st.n_dofs} DoF, variants "
        f"{variants}): {st.iterations} iterations, L2 "
        f"{st.solution_l2_norm!r} (converged {ref!r}, rel {rel:.2e})")
    say(f"phase 3 timing on {card}: setup {setup:.2f} s, first solve "
        f"{first:.2f} s (incl. compile), solve {solve:.3f} s")


def phase_parity(sizes: dict) -> None:
    """Phase 4: each production role in f32 against its f64 reference on a
    seeded random masked vector (the f32-rounded input feeds both)."""
    r = sizes["parity_refinements"]
    fine = FESpace(HyperCubeMesh(3, r), 4)
    coarse = FESpace(HyperCubeMesh(3, r - 1), 4)
    variant = best_xla_variant(fine)

    def masked_random(space, seed):
        u = jax.random.normal(jax.random.PRNGKey(seed), space.grid_shape,
                              jnp.float32)
        return u * jnp.asarray(space.free_mask(), jnp.float32)

    u32 = masked_random(fine, 0)
    ref = jax.jit(make_laplace(fine, jnp.float64, variant="sumfac",
                               precision="highest").apply)(
        u32.astype(jnp.float64))
    errs = {}
    for prec in (PRODUCTION_PRECISION, "high"):
        op = make_laplace(fine, jnp.float32, variant=variant, precision=prec)
        errs[prec] = max_rel_error(jax.jit(op.apply)(u32), ref)
    del ref
    check(errs[PRODUCTION_PRECISION] <= PARITY_RTOL,
          f"operator parity {errs[PRODUCTION_PRECISION]:.3e} > {PARITY_RTOL}")
    say(f"phase 4: operator {variant} f32 '{PRODUCTION_PRECISION}' vs sumfac "
        f"f64: max rel error {errs[PRODUCTION_PRECISION]:.3e}; same operator "
        f"at 'high' (TF32 on a GPU): {errs['high']:.3e}")

    tr32 = make_h_transfer(coarse, fine, jnp.float32)
    tr64 = make_h_transfer(coarse, fine, jnp.float64)
    c32 = masked_random(coarse, 1)
    for name, x32, f32, f64 in (
        ("restrict", u32, tr32.restrict, tr64.restrict),
        ("prolongate", c32, tr32.prolongate, tr64.prolongate),
    ):
        err = max_rel_error(jax.jit(f32)(x32),
                            jax.jit(f64)(x32.astype(jnp.float64)))
        check(err <= PARITY_RTOL,
              f"transfer {name} parity {err:.3e} > {PARITY_RTOL}")
        say(f"phase 4: h-transfer {name} f32 ({tr32.algo}) vs f64 "
            f"({tr64.algo}): max rel error {err:.3e}")


def single_card(sizes: dict, card: str) -> None:
    phase_geometric(sizes, card)
    phase_polynomial(sizes, card)
    stats = jax.devices()[0].memory_stats() or {}
    say(f"phase 5: peak device memory after phases 1-3: "
        f"{stats.get('peak_bytes_in_use', 'not reported')} bytes")
    phase_parity(sizes)


def check_placement(placement: tuple, n: int, mesh_axes: int,
                    what: str) -> None:
    """n distinct devices hold one slab each (every piece is 1 along the
    stacked mesh axes): nothing sits whole on one card."""
    devices = [d for d, _ in placement]
    check(len(placement) == n and len(set(devices)) == n,
          f"{what}: shards on {devices}")
    for dev, shape in placement:
        check(all(s == 1 for s in shape[:mesh_axes]),
              f"{what}: piece of shape {shape} on {dev}")


def four_cards(devices, card: str, r: int = SHARD_REFINEMENTS) -> None:
    """The sharded f64 solves of Q4 at ``r`` refinements against the
    single-card solve."""
    from portable_multigrid_tpu.parallel.mesh2d import Sharded2DGeometricPoisson
    from portable_multigrid_tpu.parallel.poisson import ShardedGeometricPoisson

    single = GeometricMultigridPoisson(3, 4, r, dtype=jnp.float64,
                                       variant="kron")
    x1, st1 = single.solve(rtol=1e-12)
    x1 = np.asarray(x1, np.float64)
    del single
    say(f"four: single card Q4 r={r} f64 kron: {st1.iterations} iterations")
    cases = (
        ("1D slab", 1, lambda: ShardedGeometricPoisson(
            3, 4, r, devices=devices, variant="kron", dtype=jnp.float64)),
        ("2D pencil (2, 2)", 2, lambda: Sharded2DGeometricPoisson(
            3, 4, r, mesh_shape=(2, 2), devices=devices, dtype=jnp.float64)),
    )
    for name, mesh_axes, build in cases:
        t0 = time.perf_counter()
        prob = build()
        setup = time.perf_counter() - t0
        x, st, first, solve = timed_solve(prob, 1e-12)
        x = np.asarray(x, np.float64).reshape(x1.shape)
        check(st.converged, f"{name}: not converged: {st}")
        check(st.iterations == st1.iterations,
              f"{name}: {st.iterations} iterations != single card "
              f"{st1.iterations}")
        err = max_rel_error(x, x1)
        check(err <= 1e-10, f"{name}: solution rel error {err:.3e} > 1e-10")
        check_placement(st.placement, len(devices), mesh_axes, name)
        say(f"four: {name}: {st.iterations} iterations (single card "
            f"{st1.iterations}), max rel error vs single card {err:.3e}")
        say(f"four: {name}: solution shards {list(st.placement)}")
        say(f"four: {name} timing on {card}: setup {setup:.2f} s, first "
            f"solve {first:.2f} s (incl. compile), solve {solve:.3f} s")
        del prob


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded solves")
    args = ap.parse_args(argv)

    cache_dir = enable_compile_cache()
    jax.config.update("jax_enable_x64", True)
    devices = jax.devices()
    require_gpu(devices, 4 if args.four else 1)
    import jaxlib

    say(f"phase 0: {devices[0].device_kind}, {len(devices)} device(s), "
        f"platform {devices[0].platform}")
    card = card_name_and_power()
    say(f"phase 0: nvidia-smi name, power.limit: {card}")
    card = card.splitlines()[0]
    say(f"phase 0: jax {jax.__version__}, jaxlib {jaxlib.__version__}, "
        f"compile cache {cache_dir}")
    from portable_multigrid_tpu.native import NativeUnavailable, get_lib

    t0 = time.perf_counter()
    try:
        get_lib()
        say(f"phase 0: native setup library built from pmg_native.cpp on "
            f"this machine in {time.perf_counter() - t0:.2f} s")
    except NativeUnavailable as exc:
        say(f"phase 0: native setup library not built ({exc}); the Python "
            "setup path is used")

    if args.four:
        four_cards(devices[:4], card)
    else:
        single_card(FULL_SIZES, card)
    print(result_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
