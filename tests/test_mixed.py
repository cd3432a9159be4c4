"""Mixed multigrid configurations (p/h ladder, f32 V-cycle under f64 CG) + VTU output."""

import os

import numpy as np
import jax.numpy as jnp
import pytest

from portable_multigrid_tpu.fem.mesh import HyperCubeMesh
from portable_multigrid_tpu.fem.space import FESpace
from portable_multigrid_tpu.models.mixed import (
    MixedMultigridPoisson,
    MixedPrecisionPoisson,
)
from portable_multigrid_tpu.models.poisson import GeometricMultigridPoisson


def test_mixed_ph_ladder_converges():
    """p = 4 -> 2 -> 1 on the fine mesh handing off to geometric levels."""
    prob = MixedMultigridPoisson(2, 3, p_ladder=(1, 2, 4))
    _, st = prob.solve()
    assert st.converged
    assert st.iterations <= 10


def test_mixed_precision_matches_f64_history():
    """f32 V-cycle preconditioning f64 CG must reach the same 1e-12 relative
    residual with a comparable iteration count (SURVEY.md §7 hard part d)."""
    mixed = MixedPrecisionPoisson(2, 2, 4, mg_dtype=jnp.float32)
    _, st_mixed = mixed.solve()
    full = GeometricMultigridPoisson(2, 2, 4)
    _, st_full = full.solve()
    assert st_mixed.converged and st_full.converged
    assert abs(st_mixed.iterations - st_full.iterations) <= 2
    assert st_mixed.solution_l2_norm == pytest.approx(
        st_full.solution_l2_norm, rel=1e-9
    )


def test_vtu_output(tmp_path):
    from portable_multigrid_tpu.utils.vtu import write_vti

    sp = FESpace(HyperCubeMesh(3, 2), 2)
    u = np.random.default_rng(0).standard_normal(sp.grid_shape)
    vec = np.random.default_rng(1).standard_normal((3,) + sp.grid_shape)
    path = os.path.join(tmp_path, "sol.vti")
    write_vti(path, sp, {"solution": u, "displacement": vec})
    text = open(path).read()
    assert "<VTKFile" in text and "ImageData" in text
    assert "solution" in text and "displacement" in text
    # decode round trip of the first data array
    import base64, struct, zlib

    blob = text.split('format="binary">')[1].split("</DataArray>")[0].strip()
    header_b64_len = len(base64.b64encode(struct.pack("<4I", 0, 0, 0, 0)))
    header = struct.unpack("<4I", base64.b64decode(blob[:header_b64_len]))
    data = zlib.decompress(base64.b64decode(blob[header_b64_len:]))
    vals = np.frombuffer(data, dtype=np.float32).reshape(sp.grid_shape[::-1])
    np.testing.assert_allclose(vals.transpose(), u, rtol=1e-6)


def test_iterative_refinement_reaches_f64_accuracy():
    """f32 inner CG+V-cycle solves, f64 residual refresh: 1e-12 without any
    f64 inner compute (solvers/refinement.py)."""
    import jax
    from portable_multigrid_tpu.fem.assemble import assemble_rhs
    from portable_multigrid_tpu.models.poisson import GeometricMultigridPoisson
    from portable_multigrid_tpu.ops.laplace import make_laplace
    from portable_multigrid_tpu.solvers.cg import cg
    from portable_multigrid_tpu.solvers.refinement import iterative_refinement
    from portable_multigrid_tpu.solvers.vcycle import VCycle

    dim, p, r = 2, 2, 4
    prob32 = GeometricMultigridPoisson(dim, p, r, dtype=jnp.float32)
    mg = VCycle(pre_smoothing_steps=2, post_smoothing_steps=2,
                levels=prob32.levels)
    fine = prob32.spaces[-1]
    op64 = make_laplace(fine, jnp.float64)
    b = jnp.asarray(assemble_rhs(fine), jnp.float64)

    op32 = prob32.levels[-1].op

    @jax.jit
    def run(op64, op32, mg, b):
        def inner(r32):
            return cg(op32.apply, r32, mg.apply, rtol=1e-6).x

        return iterative_refinement(op64.apply, inner, b, rtol=1e-12)

    x, cycles, res = run(op64, op32, mg, b)
    bnorm = float(np.linalg.norm(np.asarray(b).ravel()))
    assert float(res) <= 1e-12 * bnorm
    assert int(cycles) <= 5
    # matches the all-f64 solve
    prob64 = GeometricMultigridPoisson(dim, p, r)
    x64, st = prob64.solve()
    scale = np.abs(np.asarray(x64)).max()
    np.testing.assert_allclose(
        np.asarray(x), np.asarray(x64), atol=1e-10 * scale
    )
