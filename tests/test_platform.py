"""The platform module: backend resolution, dtype and precision defaults,
the compile-cache path, the device-memory budget, and one process per card
for launchers."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from one_class_ffm_tpu import platform

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_backend_is_cpu_here():
    assert platform.backend() == "cpu"
    assert platform.select("auto") == "cpu"
    assert platform.select("cpu") == "cpu"


@pytest.mark.parametrize("name", ["tpu", "METAL"])
def test_unsupported_backend_raises(monkeypatch, name):
    monkeypatch.setattr(jax, "default_backend", lambda: name)
    with pytest.raises(platform.PlatformError, match=name):
        platform.backend()


def test_unknown_platform_name_raises():
    with pytest.raises(platform.PlatformError, match="unknown platform"):
        platform.select("tpu")


def test_cli_platform_gpu_without_gpu_errors(tmp_path):
    """--platform gpu on a machine without one is an error, never a silent
    run on the CPU."""
    from one_class_ffm_tpu.data.synth import SynthSpec, write_dataset

    item, train, va = write_dataset(
        str(tmp_path), SynthSpec(n_users=20, n_items=8, seed=1))
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="")
    res = subprocess.run(
        [sys.executable, "-m", "one_class_ffm_tpu", item, train, "-t", "1",
         "--platform", "gpu"],
        capture_output=True, text=True, env=env, cwd=str(tmp_path),
        timeout=300)
    assert res.returncode == 1, res.stderr[-2000:]
    assert "--platform gpu" in res.stderr
    assert "iter" not in res.stdout


@pytest.mark.parametrize("name,want", [("cpu", "float32"),
                                       ("gpu", "bfloat16")])
def test_default_dtype_per_platform(monkeypatch, name, want):
    monkeypatch.setattr(jax, "default_backend", lambda: name)
    assert platform.default_dtype() == want
    from one_class_ffm_tpu.train import _np_dtype

    assert _np_dtype("auto") == jnp.dtype(want)


@pytest.mark.parametrize("dtype,want", [(jnp.float32, "highest"),
                                        (jnp.float64, "highest"),
                                        (jnp.bfloat16, None)])
def test_precision_scope_table(dtype, want):
    before = jax.config.jax_default_matmul_precision
    with platform.precision_scope(dtype):
        got = jax.config.jax_default_matmul_precision
    assert got == (want if want is not None else before)
    assert jax.config.jax_default_matmul_precision == before


def _dot_precisions(jaxpr):
    out = []

    def walk(jp):
        for eqn in jp.eqns:
            if eqn.primitive.name == "dot_general":
                out.append(eqn.params["precision"])
            for sub in jax.core.jaxprs_in_params(eqn.params):
                walk(sub)

    walk(jaxpr.jaxpr)
    return out


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_solver_f32_dots_trace_at_float32_precision(rng, dtype):
    """Every dot of an f32 epoch carries HIGHEST precision (f32, not TF32,
    on the GPU); bf16 epochs keep the default."""
    from conftest import make_problem, to_device_problem
    from one_class_ffm_tpu.solver.jax_solver import FFMSolver

    prob, params = make_problem(rng, k=4)
    meta, data = to_device_problem(prob, dtype=dtype, multiple=4,
                                   blocked_bm=4)
    solver = FFMSolver(meta, data)
    state = solver.init(jax.random.key(0))
    jaxpr = jax.make_jaxpr(solver._bound(solver._epoch_impl))(state, data)
    precs = _dot_precisions(jaxpr)
    assert precs, "the epoch has dots"
    hi = jax.lax.Precision.HIGHEST
    if dtype == np.float32:
        assert all(p == (hi, hi) for p in precs), set(precs)
    else:
        assert all(p != (hi, hi) for p in precs), set(precs)


def test_compile_cache_dir(monkeypatch):
    monkeypatch.delenv(platform.CACHE_ENV, raising=False)
    path = platform.compile_cache_dir()
    assert path == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()
    monkeypatch.setenv(platform.CACHE_ENV, "/elsewhere/cache")
    assert platform.compile_cache_dir() == "/elsewhere/cache"


def test_enable_compile_cache_sets_config(monkeypatch):
    monkeypatch.setenv(platform.CACHE_ENV, os.path.join(REPO, ".jax_cache"))
    before = jax.config.jax_compilation_cache_dir
    try:
        assert platform.enable_compile_cache() == os.path.join(
            REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == os.path.join(
            REPO, ".jax_cache")
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("env,want", [("0,2", ["0", "2"]), ("", []),
                                      (" 3 ", ["3"])])
def test_visible_gpus_follows_env(monkeypatch, env, want):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", env)
    assert platform.visible_gpus() == want


def test_device_bytes_limit(monkeypatch):
    from one_class_ffm_tpu.solver import jax_solver

    monkeypatch.delenv("OCFFM_HBM_GB", raising=False)
    assert jax_solver._device_bytes_limit() == 0  # the CPU reports none
    monkeypatch.setenv("OCFFM_HBM_GB", "2")
    assert jax_solver._device_bytes_limit() == 2 << 30
    # a GPU that reports no limit is an error, not a 16 GB guess
    monkeypatch.delenv("OCFFM_HBM_GB")
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    with pytest.raises(RuntimeError, match="bytes_limit"):
        jax_solver._device_bytes_limit()


def test_pregather_budget_counts_logical_bytes(rng, monkeypatch):
    """The pregather cap is half the device budget left after the problem
    arrays, the state, one solve's transients and the CG vectors — all in
    logical bytes (no lane or sublane padding)."""
    from conftest import make_problem, to_device_problem
    from one_class_ffm_tpu.solver.jax_solver import FFMSolver

    prob, _ = make_problem(rng, k=4)
    meta, data = to_device_problem(prob, dtype=np.float32, multiple=4,
                                   blocked_bm=4)
    k, isz = meta.hp.k, 4
    state_b = trans_b = 0
    max_d = 1
    for b in meta.layout.all_blocks():
        r1 = meta.m if b.f1 < meta.layout.fu else meta.n
        r2 = meta.m if b.f2 < meta.layout.fu else meta.n
        state_b += (b.d1 + b.d2 + r1 + r2) * k * isz
        max_d = max(max_d, b.d1, b.d2)
        trans_b = max(trans_b, (b.d1 + r1) * k * isz, (b.d2 + r2) * k * isz)
    state_b += 2 * meta.nnz * isz
    data_b = sum(a.nbytes for a in jax.tree.leaves(data))
    budget = (1 << 30) - data_b - state_b - trans_b - 5 * k * max_d * 4
    monkeypatch.setenv("OCFFM_HBM_GB", "1")
    assert FFMSolver(meta, data).pregather_cap == min(400 << 20,
                                                      budget // 2)


def test_chip_smoke_fails_without_gpu(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line here, and in a
    directory that holds nothing else of the repository."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "no GPU" in res.stderr
    lone = tmp_path / "chip_smoke.py"
    lone.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, str(lone)], capture_output=True,
                         text=True, env=env, cwd=str(tmp_path), timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
