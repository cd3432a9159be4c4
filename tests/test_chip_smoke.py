"""chip_smoke.py's helpers and the entry points' device rules, on the CPU.

The script itself needs a GPU; here its checks, its result line, its
refusal of any other platform and its phases at tiny sizes are exercised,
together with the compile-cache placement and the native library build
that every entry point shares."""

import json
import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from portable_multigrid_tpu.utils import compile_cache  # noqa: E402


def _stats(**kw):
    base = dict(converged=True, n_dofs=35937, iterations=5,
                solution_l2_norm=0.024987133366358244)
    base.update(kw)
    return SimpleNamespace(**base)


def _run(args, cwd, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    env.update(env_extra or {})
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_result_line_is_the_exact_contract():
    dev = SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
    line = chip_smoke.result_line([dev])
    assert line == ('{"ok": true, "device": {"platform": "gpu", '
                    '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}')
    assert json.loads(line)["device"]["count"] == 1
    assert json.loads(chip_smoke.result_line([dev] * 4))["device"]["count"] == 4


def test_require_gpu_refuses_the_cpu():
    with pytest.raises(SystemExit) as exc:
        chip_smoke.require_gpu(jax.devices(), 1)
    assert exc.value.code not in (0, None)


def test_require_gpu_refuses_too_few_cards():
    gpu = SimpleNamespace(platform="gpu", device_kind="x")
    chip_smoke.require_gpu([gpu], 1)
    with pytest.raises(SystemExit):
        chip_smoke.require_gpu([gpu], 4)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py", "bench_all.py"])
def test_scripts_exit_nonzero_without_a_gpu(script):
    r = _run([script], ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs a GPU" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], str(tmp_path))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_golden_row_check_passes_on_the_row():
    row = chip_smoke.golden_geometric(4, 3)
    chip_smoke.check_golden_row(_stats(), row)


@pytest.mark.parametrize("bad", [
    {"iterations": 6},
    {"solution_l2_norm": 0.024987133366358244 * (1 + 1e-9)},
    {"converged": False},
    {"n_dofs": 4913},
])
def test_golden_row_check_refuses(bad):
    row = chip_smoke.golden_geometric(4, 3)
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.check_golden_row(_stats(**bad), row)


def test_converged_norms_are_the_finest_highest_degree_rows():
    # Q7 r=3 (185,193 DoF) and the 2D Q7 r=2 ladder rows
    assert chip_smoke.converged_norm("geometric_3d") == 0.02498713312835196
    assert chip_smoke.converged_norm("polynomial_2d") == 0.0412614896113732
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.check_norm(0.0249875, 0.02498713, 1e-7, "x")


def test_check_placement():
    good = tuple((f"cuda:{i}", (1, 65, 257, 257)) for i in range(4))
    chip_smoke.check_placement(good, 4, 1, "slab")
    whole = (("cuda:0", (4, 65, 257, 257)),)
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.check_placement(whole, 4, 1, "slab")
    two_on_one = good[:3] + (("cuda:0", (1, 65, 257, 257)),)
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.check_placement(two_on_one, 4, 1, "slab")


def test_single_card_phases_at_tiny_size(capsys):
    """Phases 1-5 end to end on the CPU at sizes where the same checks hold
    (Q4 r=3 is within 1e-7 of the converged L2 norm)."""
    chip_smoke.single_card({"geo_refinements": 3, "golden_refinements": 2,
                            "poly_refinements": 2, "parity_refinements": 2},
                           "cpu")
    out = capsys.readouterr().out
    for phase in ("phase 1", "phase 2", "phase 3", "phase 4", "phase 5"):
        assert phase in out


def test_four_card_phase_at_tiny_size(capsys):
    """The --four phase on four virtual CPU devices: slab and pencil solves
    equal to the single-device solve, one piece per device."""
    chip_smoke.four_cards(jax.devices()[:4], "cpu", r=2)
    out = capsys.readouterr().out
    assert "four: 1D slab" in out and "four: 2D pencil (2, 2)" in out


def test_sharded_solutions_are_placed_one_slab_per_device():
    from portable_multigrid_tpu.parallel.poisson import ShardedGeometricPoisson

    prob = ShardedGeometricPoisson(3, 1, 2, devices=jax.devices()[:4],
                                   variant="kron")
    _, st = prob.solve(rtol=1e-8)
    chip_smoke.check_placement(st.placement, 4, 1, "slab")


# ---------------------------------------------------------------------------
# compile cache and native library
# ---------------------------------------------------------------------------

def test_compile_cache_honours_the_environment(monkeypatch):
    monkeypatch.setenv(compile_cache.ENV_VAR, "/somewhere/else")
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == "/somewhere/else"
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_inside_the_checkout(monkeypatch):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.enable_compile_cache()
        assert path == os.path.join(ROOT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_native_library_is_built_here_and_not_kept():
    """Every process compiles its own library; no .so stays on disk to be
    carried to another machine."""
    r = _run(["-c", "from portable_multigrid_tpu.native import get_lib; "
              "get_lib(); print('loaded')"], ROOT)
    assert r.returncode == 0, r.stderr
    assert "loaded" in r.stdout
    build = os.path.join(ROOT, "build", "native")
    assert not [f for f in os.listdir(build) if f.endswith(".so")]
    pkg = os.path.join(ROOT, "portable_multigrid_tpu", "native")
    assert not [f for f in os.listdir(pkg) if f.endswith(".so")]
