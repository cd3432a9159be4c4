"""Multi-chip sharding tests on the virtual CPU device mesh (conftest: 8 devices).

The analog of the reference's "same binary under mpirun -n N"
story (SURVEY.md §4): sharded results must match the single-device solver to
roundoff."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from portable_multigrid_tpu.fem.mesh import HyperCubeMesh
from portable_multigrid_tpu.fem.space import FESpace
from portable_multigrid_tpu.ops.laplace import make_laplace
from portable_multigrid_tpu.parallel.poisson import (
    ShardedGeometricPoisson,
    _build_stacked_operator,
    _unstack,
    AXIS,
)
from portable_multigrid_tpu.parallel.sharding import (
    ShardedLaplaceOperator,
    dot_weights_axis0,
    make_sharded_dot,
    partition_axis0,
    unpartition_axis0,
)
from portable_multigrid_tpu.models.poisson import GeometricMultigridPoisson


def _mesh(n):
    return Mesh(np.array(jax.devices()[:n]), (AXIS,))


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_sharded_apply_matches_single_device(n_dev):
    dim, p, r = 3, 2, 3
    sp = FESpace(HyperCubeMesh(dim, r), p)
    op = make_laplace(sp)
    rng = np.random.default_rng(0)
    u = rng.standard_normal(sp.grid_shape)
    want = np.asarray(op.apply(u))

    op_st = _build_stacked_operator(sp, n_dev, jnp.float64)
    u_st = jnp.asarray(partition_axis0(u, sp.mesh.cells_per_axis, p, n_dev))

    def f(op_stacked, u_stacked):
        sop = ShardedLaplaceOperator(
            axis_name=AXIS, n_shards=n_dev, local=_unstack(op_stacked)
        )
        return sop.apply(u_stacked[0])[None]

    got_st = jax.jit(
        jax.shard_map(
            f,
            mesh=_mesh(n_dev),
            in_specs=(P(AXIS), P(AXIS)),
            out_specs=P(AXIS),
            check_vma=False,
        )
    )(op_st, u_st)
    got = unpartition_axis0(np.asarray(got_st), sp.mesh.cells_per_axis, p, n_dev)
    np.testing.assert_allclose(got, want, atol=1e-12 * np.abs(want).max())
    # and the duplicated planes are consistent on both owners
    for s in range(n_dev - 1):
        np.testing.assert_array_equal(
            np.asarray(got_st)[s][-1], np.asarray(got_st)[s + 1][0]
        )


@pytest.mark.parametrize("n_dev", [2, 8])
def test_sharded_dot_matches_global(n_dev):
    dim, p, r = 2, 3, 3
    sp = FESpace(HyperCubeMesh(dim, r), p)
    rng = np.random.default_rng(1)
    a = rng.standard_normal(sp.grid_shape)
    b = rng.standard_normal(sp.grid_shape)
    want = np.vdot(a, b)
    n = sp.mesh.cells_per_axis
    a_st = jnp.asarray(partition_axis0(a, n, p, n_dev))
    b_st = jnp.asarray(partition_axis0(b, n, p, n_dev))
    w_st = jnp.asarray(dot_weights_axis0(n, p, n_dev))

    def f(a_s, b_s, w_s):
        dot = make_sharded_dot(w_s[0], dim, AXIS)
        return dot(a_s[0], b_s[0])

    got = jax.jit(
        jax.shard_map(
            f,
            mesh=_mesh(n_dev),
            in_specs=(P(AXIS), P(AXIS), P(AXIS)),
            out_specs=P(),
            check_vma=False,
        )
    )(a_st, b_st, w_st)
    assert float(got) == pytest.approx(want, rel=1e-13)


def test_sharded_solve_matches_single_device():
    dim, p, r = 3, 2, 3
    sharded = ShardedGeometricPoisson(dim, p, r, devices=jax.devices()[:8])
    x_s, st_s = sharded.solve()
    single = GeometricMultigridPoisson(dim, p, r)
    x_1, st_1 = single.solve()
    assert st_s.converged and st_1.converged
    # levels below shard granularity are replicated, so the sharded
    # hierarchy reaches the same 1-cell base mesh as the single-device
    # solver (reference: source/geometric_multigrid/program.cc:137-147) and
    # the iteration count matches EXACTLY.
    assert st_s.dofs_per_level == st_1.dofs_per_level
    assert st_s.iterations == st_1.iterations
    scale = np.abs(np.asarray(x_1)).max()
    np.testing.assert_allclose(
        np.asarray(x_s).reshape(-1),
        np.asarray(x_1).reshape(-1),
        atol=1e-9 * scale,
    )


def test_sharded_solve_two_devices():
    sharded = ShardedGeometricPoisson(2, 3, 3, devices=jax.devices()[:2])
    x, st = sharded.solve()
    single = GeometricMultigridPoisson(2, 3, 3)
    _, st_1 = single.solve()
    assert st.converged
    assert st.iterations == st_1.iterations
    assert st.solution_l2_norm == pytest.approx(0.0412615, rel=1e-4)


def test_sharded_polynomial_solve_matches_single_device():
    from portable_multigrid_tpu.parallel.poisson import ShardedPolynomialPoisson
    from portable_multigrid_tpu.models.poisson import PolynomialMultigridPoisson

    sharded = ShardedPolynomialPoisson(3, 3, 3, 3, devices=jax.devices()[:4])
    x_s, st_s = sharded.solve()
    single = PolynomialMultigridPoisson(3, 3, 3, 3)
    x_1, st_1 = single.solve()
    assert st_s.converged and st_1.converged
    scale = np.abs(np.asarray(x_1)).max()
    np.testing.assert_allclose(
        np.asarray(x_s).reshape(-1), np.asarray(x_1).reshape(-1),
        atol=1e-10 * scale,
    )


def test_sharded_elasticity_matches_single_device():
    from portable_multigrid_tpu.parallel.elasticity import ShardedElasticity
    from portable_multigrid_tpu.models.elasticity import ElasticityMultigrid

    sharded = ShardedElasticity(3, 2, 2, devices=jax.devices()[:4])
    x_s, st_s = sharded.solve()
    single = ElasticityMultigrid(3, 2, 2)
    x_1, st_1 = single.solve()
    assert st_s.converged and st_1.converged
    scale = np.abs(np.asarray(x_1)).max()
    np.testing.assert_allclose(
        np.asarray(x_s), np.asarray(x_1), atol=1e-10 * scale
    )


def test_sharded_kron_variant_matches_single_device():
    sharded = ShardedGeometricPoisson(
        3, 2, 3, devices=jax.devices()[:4], variant="kron"
    )
    x_s, st_s = sharded.solve()
    single = GeometricMultigridPoisson(3, 2, 3)
    x_1, st_1 = single.solve()
    assert st_s.converged
    scale = np.abs(np.asarray(x_1)).max()
    np.testing.assert_allclose(
        np.asarray(x_s).reshape(-1), np.asarray(x_1).reshape(-1),
        atol=1e-9 * scale,
    )


def test_2d_device_mesh_matches_single_device():
    """Pencil decomposition over a 4x2 device mesh (halo order handles the
    4-way corner duplication transitively)."""
    from portable_multigrid_tpu.parallel.mesh2d import Sharded2DGeometricPoisson

    prob = Sharded2DGeometricPoisson(3, 2, 3, mesh_shape=(4, 2))
    x, st = prob.solve()
    single = GeometricMultigridPoisson(3, 2, 3)
    x1, _ = single.solve()
    assert st.converged
    scale = np.abs(np.asarray(x1)).max()
    np.testing.assert_allclose(
        np.asarray(x), np.asarray(x1), atol=1e-9 * scale
    )


def test_2d_device_mesh_2x2():
    from portable_multigrid_tpu.parallel.mesh2d import Sharded2DGeometricPoisson

    prob = Sharded2DGeometricPoisson(2, 3, 3, mesh_shape=(2, 2))
    x, st = prob.solve()
    assert st.converged
    assert st.solution_l2_norm == pytest.approx(0.0412615, rel=1e-4)


def test_sharded_eigenvalue_setup_matches_twin():
    """Fully-sharded setup (eig CG inside shard_map) gives the same solve as
    the single-device-twin setup — no chip needs to hold the global level."""
    a = ShardedGeometricPoisson(
        3, 2, 3, devices=jax.devices()[:4], variant="kron", sharded_setup=True
    )
    x_a, st_a = a.solve()
    b = ShardedGeometricPoisson(3, 2, 3, devices=jax.devices()[:4],
                                variant="kron")
    x_b, st_b = b.solve()
    assert st_a.converged and st_a.iterations == st_b.iterations
    scale = np.abs(np.asarray(x_b)).max()
    np.testing.assert_allclose(np.asarray(x_a), np.asarray(x_b),
                               atol=1e-10 * scale)


@pytest.mark.parametrize("n_dev", [3, 6])
def test_extended_arbitrary_shard_counts(n_dev):
    """Non-power-of-two chip counts: the extended-domain
    padding solves the SAME unit-cube problem on any S — live-region
    solution matches the single-device solver, O(1) iterations."""
    from portable_multigrid_tpu.parallel.extended import ExtendedShardedPoisson

    dim, p, r = 3, 2, 3
    prob = ExtendedShardedPoisson(
        dim, p, r, devices=jax.devices()[:n_dev], dtype=jnp.float64
    )
    x, st = prob.solve(rtol=1e-10)
    assert st.converged
    single = GeometricMultigridPoisson(dim, p, r, dtype=jnp.float64)
    x1, st1 = single.solve(rtol=1e-10)
    # the extended hierarchy bottoms out at S cells (not 1), so counts are
    # O(1) but need not be identical
    assert st.iterations <= st1.iterations + 2
    assert st.solution_l2_norm == pytest.approx(st1.solution_l2_norm,
                                                rel=1e-9)
    np.testing.assert_allclose(
        np.asarray(x), np.asarray(x1).reshape(x.shape),
        atol=1e-9 * np.abs(np.asarray(x1)).max(),
    )
