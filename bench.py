"""Benchmark on one GPU: operator applies, transfers and the V-cycle.

Run from the repository root (one process holds the card):

    python bench.py [--out bench.jsonl]

Every record is one JSON line on stdout (and in ``--out``) naming the
platform, ``device_kind``, the device count and the card's name and power
limit (``nvidia-smi``).  Times are host-clock medians of repeated calls that
end in ``block_until_ready``; compilation is reported apart as
``compile_s``.  Records:

  * ``copy``: the rate a large f32 ``x + 1`` reaches (bytes read + written
    per second), the card's practical bandwidth ceiling;
  * ``apply``: one fine-level operator apply per (problem, variant, dtype,
    precision), with ``hbm_bound_s`` = (read + write of one vector) /
    peak bandwidth and ``x_hbm_bound`` = time / bound;
  * ``transfer``: one restrict + prolongate pair at Q4 r=6, per contraction
    algorithm;
  * ``vcycle``: one V(2,2) application of the production f32 hierarchy
    (``variant="auto"`` and each forced variant), with V-cycle DoF/s.

Refuses to run without a GPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import jax
import jax.numpy as jnp

from portable_multigrid_tpu.fem.mesh import HyperCubeMesh
from portable_multigrid_tpu.fem.space import FESpace
from portable_multigrid_tpu.models.poisson import GeometricMultigridPoisson
from portable_multigrid_tpu.ops.laplace import make_laplace
from portable_multigrid_tpu.ops.transfer import make_h_transfer
from portable_multigrid_tpu.solvers.vcycle import VCycle
from portable_multigrid_tpu.utils.compile_cache import enable_compile_cache

# Peak device-memory bandwidth by device_kind (NVIDIA data sheets); a card
# that is not listed is an error, not a default.
PEAK_HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,  # H100 SXM
}

VARIANTS = ("kron", "bkron", "sumfac", "dense")
# (dim, degree, refinements): the two 3D sizes at N = 257 points per axis,
# the 3D Q4 size at N = 513, and the 2D p-ladder's fine level (N = 1793)
APPLY_CASES = ((3, 4, 6), (3, 2, 7), (3, 4, 7), (2, 7, 8))
# the 2D ladder's levels, kron against bkron across N = 257 ... 1793
LADDER_CASES = tuple((2, p, 8) for p in range(1, 8))


def card_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_call(f, *args, reps: int = 5, inner: int = 10):
    """(compile_s, median seconds per call) of the jitted ``f(*args)``."""
    t0 = time.perf_counter()
    jax.block_until_ready(f(*args))
    compile_s = time.perf_counter() - t0
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(inner):
            out = f(*args)
        jax.block_until_ready(out)
        samples.append((time.perf_counter() - t0) / inner)
    return compile_s, statistics.median(samples)


class Recorder:
    def __init__(self, out_path: str | None, device_fields: dict):
        self.device_fields = device_fields
        self.fh = None
        if out_path:
            os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
            self.fh = open(out_path, "w")

    def emit(self, record: dict) -> None:
        line = json.dumps({**record, **self.device_fields})
        print(line, flush=True)
        if self.fh is not None:
            self.fh.write(line + "\n")
            self.fh.flush()

    def close(self) -> None:
        if self.fh is not None:
            self.fh.close()


def masked_random(space: FESpace, dtype, seed: int):
    u = jax.random.normal(jax.random.PRNGKey(seed), space.grid_shape, dtype)
    return u * jnp.asarray(space.free_mask(), dtype)


def bench_copy(rec: Recorder, peak: float) -> None:
    x = jnp.zeros((256, 1024, 1024), jnp.float32)  # 1 GiB
    f = jax.jit(lambda v: v + 1.0)
    _, t = time_call(f, x)
    nbytes = 2 * x.size * 4
    rec.emit({"kind": "copy", "bytes": nbytes, "time_s": t,
              "bytes_per_s": nbytes / t, "share_of_peak": nbytes / t / peak})


def bench_apply(rec: Recorder, peak: float, cases, variants, dtypes,
                precisions) -> None:
    for dim, degree, refinements in cases:
        sp = FESpace(HyperCubeMesh(dim, refinements), degree)
        for dtype in dtypes:
            u = masked_random(sp, dtype, 0)
            bound = 2 * sp.n_dofs * u.dtype.itemsize / peak
            for variant in variants:
                for prec in precisions:
                    op = make_laplace(sp, dtype, variant=variant,
                                      precision=prec)
                    compile_s, t = time_call(jax.jit(type(op).apply), op, u)
                    rec.emit({
                        "kind": "apply", "dim": dim, "degree": degree,
                        "refinements": refinements, "n_dofs": sp.n_dofs,
                        "points_per_axis": sp.points_per_axis,
                        "variant": variant, "dtype": jnp.dtype(dtype).name,
                        "precision": prec, "time_s": t,
                        "dofs_per_s": sp.n_dofs / t, "compile_s": compile_s,
                        "hbm_bound_s": bound, "x_hbm_bound": t / bound,
                    })
                    del op
            del u


def bench_transfer(rec: Recorder, peak: float) -> None:
    fine = FESpace(HyperCubeMesh(3, 6), 4)
    coarse = FESpace(HyperCubeMesh(3, 5), 4)
    base = make_h_transfer(coarse, fine, jnp.float32)
    f = masked_random(fine, jnp.float32, 0)
    # bytes of the pair: read fine, write coarse, read coarse, write fine
    bound = 2 * 4 * (fine.n_dofs + coarse.n_dofs) / peak
    for algo in ("unrolled", "dot"):
        tr = dataclasses.replace(base, algo=algo)

        def pair(tr, f):
            return tr.prolongate(tr.restrict(f))

        compile_s, t = time_call(jax.jit(pair), tr, f)
        rec.emit({"kind": "transfer", "dim": 3, "degree": 4,
                  "refinements": 6, "algo": algo, "time_s": t,
                  "compile_s": compile_s, "hbm_bound_s": bound,
                  "x_hbm_bound": t / bound})


def bench_vcycle(rec: Recorder, refinements: int, variants) -> None:
    for variant in variants:
        t0 = time.perf_counter()
        prob = GeometricMultigridPoisson(3, 4, refinements,
                                         dtype=jnp.float32, variant=variant)
        setup_s = time.perf_counter() - t0
        fine = prob.spaces[-1]
        mg = VCycle(pre_smoothing_steps=2, post_smoothing_steps=2,
                    levels=prob.levels)
        b = masked_random(fine, jnp.float32, 1)
        compile_s, t = time_call(jax.jit(VCycle.apply), mg, b, inner=3)
        rec.emit({
            "kind": "vcycle", "dim": 3, "degree": 4,
            "refinements": refinements, "n_dofs": fine.n_dofs,
            "variant": variant,
            "fine_variant": prob.levels[-1].op.variant,
            "dtype": "float32",
            "precision": prob.levels[-1].op.precision,
            "time_s": t, "dofs_per_s": fine.n_dofs / t,
            "setup_s": setup_s, "compile_s": compile_s,
        })
        del prob, mg, b


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write the records to this JSON-lines file")
    args = ap.parse_args(argv)

    enable_compile_cache()
    jax.config.update("jax_enable_x64", True)
    dev = jax.devices()
    if dev[0].platform != "gpu":
        raise SystemExit(
            f"bench: needs a GPU, JAX found platform {dev[0].platform!r}"
        )
    kind = dev[0].device_kind
    if kind not in PEAK_HBM_BYTES_PER_S:
        raise SystemExit(f"bench: no peak bandwidth for device {kind!r}")
    peak = PEAK_HBM_BYTES_PER_S[kind]
    rec = Recorder(args.out, {
        "platform": dev[0].platform, "device_kind": kind,
        "device_count": len(dev), "card": card_name_and_power(),
        "peak_hbm_bytes_per_s": peak,
    })
    try:
        bench_copy(rec, peak)
        bench_apply(rec, peak, APPLY_CASES, VARIANTS, (jnp.float32,),
                    ("highest", "high"))
        bench_apply(rec, peak, APPLY_CASES[:1], VARIANTS, (jnp.float64,),
                    ("highest",))
        bench_apply(rec, peak, LADDER_CASES, ("kron", "bkron"),
                    (jnp.float32, jnp.float64), ("highest",))
        bench_transfer(rec, peak)
        bench_vcycle(rec, 6, ("auto",) + VARIANTS)
    finally:
        rec.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
