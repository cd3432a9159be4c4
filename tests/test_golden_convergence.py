"""Golden convergence regression: iteration counts and L2 norms.

The reference's correctness oracles (CG iteration count + solution norm,
reference: source/geometric_multigrid/program.cc:354-355,395) recorded for
its driver configurations in tests/golden_convergence.json (generated by
tests/generate_golden.py in f64 on CPU).  Any change to the operator,
transfers, smoother rules or CG must keep these bit-stable oracles:
iteration counts exactly, norms to 1e-10 relative.
"""

import json
import os

import pytest

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_convergence.json")


def _load():
    with open(GOLDEN) as f:
        return json.load(f)


# a fast subset always runs; the FULL recorded table (every config the
# generator produced) replays in the slow-marked tests below.  Every degree
# p = 1..7 has a row in the fast subset.
FAST_GEO = [(1, 2), (2, 2), (3, 1), (4, 1), (5, 1), (6, 1), (7, 1)]
FULL_GEO = [(d, r) for d in (1, 2, 3, 4, 5, 6, 7) for r in (1, 2, 3)]


def _check_geo(degree, refinements):
    from portable_multigrid_tpu.models.poisson import GeometricMultigridPoisson

    golden = {
        (r["degree"], r["refinements"]): r for r in _load()["geometric_3d"]
    }
    want = golden[(degree, refinements)]
    _, st = GeometricMultigridPoisson(3, degree, refinements).solve()
    assert st.converged
    assert st.iterations == want["iterations"]
    assert st.solution_l2_norm == pytest.approx(want["l2_norm"], rel=1e-10)
    assert st.n_dofs == want["n_dofs"]


@pytest.mark.parametrize("degree,refinements", FAST_GEO)
def test_geometric_golden(degree, refinements):
    _check_geo(degree, refinements)


@pytest.mark.slow
@pytest.mark.parametrize(
    "degree,refinements", [c for c in FULL_GEO if c not in FAST_GEO]
)
def test_geometric_golden_full_table(degree, refinements):
    _check_geo(degree, refinements)


def _check_poly(idx):
    from portable_multigrid_tpu.models.poisson import PolynomialMultigridPoisson

    want = _load()["polynomial_2d"][idx]
    _, st = PolynomialMultigridPoisson(
        2, want["degree"], want["refinements"], want["levels"]
    ).solve()
    assert st.converged
    assert st.iterations == want["iterations"]
    assert st.solution_l2_norm == pytest.approx(want["l2_norm"], rel=1e-10)


def test_polynomial_golden():
    _check_poly(0)  # Q7, 7 levels, r=1


@pytest.mark.slow
@pytest.mark.parametrize("idx", [1, 2])
def test_polynomial_golden_full_table(idx):
    _check_poly(idx)


def test_iteration_counts_bounded_and_mesh_independent():
    """MG quality: O(1) iterations across every recorded configuration."""
    data = _load()
    all_iters = [r["iterations"] for r in data["geometric_3d"]] + [
        r["iterations"] for r in data["polynomial_2d"]
    ]
    assert max(all_iters) <= 6
    assert all(r["converged"] for r in data["geometric_3d"])
