"""Test configuration: CPU backend with 8 virtual devices, float64 enabled.

The multi-chip analog of the reference's "same binary under mpirun -n N"
story (SURVEY.md §4): sharding tests run on a virtual CPU mesh; numerical
golden tests run in f64, which the CPU backend executes natively.
"""

import os

# Must be configured before jax initializes a backend: the tests run on the
# CPU even where JAX would pick a GPU, with 8 virtual devices for the
# sharding tests.
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)

import pytest


# ---------------------------------------------------------------------------
# Fast tier (`pytest -m "not slow"`): the full suite is the gate but takes
# over an hour on one core, which is how suites stop being run.  The list
# below is duration-derived (every test function
# whose slowest parametrization exceeded 40 s in a full `--durations=0`
# run) — regenerate after adding heavy tests.  The slow set is dominated by
# end-to-end convergence-count replays; every subsystem keeps faster
# parity/property tests in the fast tier.
# ---------------------------------------------------------------------------
_SLOW_TESTS = {
    "test_curved.py::test_curved_multigrid_convergence",
    "test_golden_convergence.py::test_geometric_golden",
    "test_golden_convergence.py::test_geometric_golden_full_table",
    "test_golden_convergence.py::test_polynomial_golden",
    "test_golden_convergence.py::test_polynomial_golden_full_table",
    "test_manufactured.py::test_l2_error_rate_2d",
    "test_manufactured.py::test_l2_error_rate_3d",
    "test_mixed.py::test_iterative_refinement_reaches_f64_accuracy",
    "test_mixed.py::test_mixed_ph_ladder_converges",
    "test_mixed.py::test_mixed_precision_matches_f64_history",
    "test_operator.py::test_bkron_solve_count_parity",
    "test_sharding.py::test_extended_arbitrary_shard_counts",
    "test_sharding.py::test_sharded_elasticity_matches_single_device",
    "test_sharding.py::test_sharded_polynomial_solve_matches_single_device",
    "test_sharding.py::test_sharded_solve_matches_single_device",
    "test_sharding.py::test_sharded_solve_two_devices",
    "test_solvers.py::test_eig_cap_large_coarse_level_convergence",
    "test_solvers.py::test_geometric_mg_iteration_counts",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        name = getattr(item, "originalname", None) or item.name.split("[")[0]
        key = f"{os.path.basename(item.fspath)}::{name}"
        if key in _SLOW_TESTS:
            item.add_marker(pytest.mark.slow)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Drop compiled executables between test modules.

    The XLA CPU compiler segfaults intermittently deep into the 200+-test
    single-process run (observed twice around test #160, each time inside
    backend_compile, with >120 GB RAM free); clearing the jit caches between
    modules keeps the compiler state small and has eliminated the crash in
    practice.  Costs a few recompiles of shared tiny programs.
    """
    yield
    jax.clear_caches()
