"""f32 production hierarchy against the f64 golden table.

The production V-cycle runs in f32 (operator variant "auto", every
contraction at "highest"); preconditioning the f64 outer CG with it must
reproduce the golden f64 rows exactly: equal CG counts to 1e-12 ||b|| and
L2 norms to 1e-10 (tests/golden_convergence.json, the repo's rule).
"""

import json
import os

import jax.numpy as jnp
import pytest

from portable_multigrid_tpu.models.mixed import MixedPrecisionPoisson

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_convergence.json")


def _golden(degree, refinements):
    with open(GOLDEN) as f:
        rows = json.load(f)["geometric_3d"]
    return next(r for r in rows
                if (r["degree"], r["refinements"]) == (degree, refinements))


@pytest.mark.parametrize("degree", range(1, 8))
@pytest.mark.parametrize("refinements", [1, 2])
def test_f32_production_vcycle_matches_golden_counts(refinements, degree):
    want = _golden(degree, refinements)
    prob = MixedPrecisionPoisson(3, degree, refinements,
                                 mg_dtype=jnp.float32, variant="auto")
    _, st = prob.solve(rtol=1e-12)
    assert st.converged
    assert st.iterations == want["iterations"]
    assert st.solution_l2_norm == pytest.approx(want["l2_norm"], rel=1e-10)
