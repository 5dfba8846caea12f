"""JAX solver vs the fp64 numpy oracle: gradients, Hv, CG steps, full epochs.

The oracle brute-forces everything from the dense residual matrix
(solver/oracle.py); the JAX solver uses the rank-k algebra (segment sums,
k x k Grams, incremental residuals).  Agreement on random tiny problems is a
strong end-to-end check of the fast math (reference ffm.cpp:314-870).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conftest import make_problem, oracle_params_to_jax, to_device_problem
from one_class_ffm_tpu.solver import oracle
from one_class_ffm_tpu.solver.jax_solver import FFMSolver


def build(rng, row_pad=0, **kw):
    prob, params = make_problem(rng, **kw)
    meta, data = to_device_problem(prob, row_pad=row_pad)
    solver = FFMSolver(meta, data)
    state = solver.refresh_caches({"params": oracle_params_to_jax(params)})
    return prob, params, solver, state


CONFIGS = [
    dict(),  # ffm, self blocks
    dict(self_side=False),  # ffm --ns
    dict(freq=True),  # freq-weighted lambda
    dict(Du=(7,), Dv=(6,)),  # fm-like: one field per side
    dict(Du=(7,), Dv=(6,), self_side=False),  # mf-like
    dict(omega=1.0, r=0.0),  # degenerate: uniform weights
    dict(cg_precond="none"),  # reference-exact plain CG (ffm.cpp:744-813)
]


@pytest.mark.parametrize("cfg", CONFIGS)
def test_pos_residuals_match(rng, cfg):
    prob, params, solver, state = build(rng, **cfg)
    yh = oracle.predict_dense(prob, params)
    uu, vv = np.nonzero(prob.pos)
    got = np.asarray(state["yt"])[: uu.size]
    np.testing.assert_allclose(got, yh[uu, vv] - 1.0, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("cfg", CONFIGS)
@pytest.mark.parametrize("row_pad", [0, 3])
def test_gradients_match_oracle(rng, cfg, row_pad):
    prob, params, solver, state = build(rng, row_pad=row_pad, **cfg)
    sa, sb = solver._cache_sasb(state["P"], state["Q"])
    for b in prob.layout.all_blocks():
        for first in (True, False):
            G_ref, _ = oracle.grad_and_hv(prob, params, b, first)
            if b.kind == "uv":
                G = solver._grad_cross(state, b, first)
            else:
                G = solver._grad_self(state, b, first, sa, sb)
            np.testing.assert_allclose(
                np.asarray(G), G_ref, rtol=1e-8, atol=1e-10,
                err_msg=f"block {b} first={first}",
            )


@pytest.mark.parametrize("cfg", CONFIGS[:3])
def test_hessian_vector_match_oracle(rng, cfg):
    prob, params, solver, state = build(rng, **cfg)
    for b in prob.layout.all_blocks():
        for first in (True, False):
            _, hv_ref = oracle.grad_and_hv(prob, params, b, first)
            if b.kind == "uv":
                hv = solver._hv_cross(state, b, first)
            else:
                hv = solver._hv_self(state, b, first)
            d = b.d1 if first else b.d2
            V = rng.normal(size=(d, prob.hp.k))
            np.testing.assert_allclose(
                np.asarray(hv(jnp.asarray(V))), hv_ref(V),
                rtol=1e-8, atol=1e-10, err_msg=f"block {b} first={first}",
            )


@pytest.mark.parametrize("cfg", CONFIGS)
def test_objective_matches_oracle(rng, cfg):
    prob, params, solver, state = build(rng, **cfg)
    ref = oracle.objective(prob, params)
    got = float(solver.objective(state))
    np.testing.assert_allclose(got, ref, rtol=1e-9)


@pytest.mark.parametrize("cfg", CONFIGS)
@pytest.mark.parametrize("row_pad", [0, 3])
def test_full_epoch_matches_oracle(rng, cfg, row_pad):
    # disable_jit: math-parity check without paying XLA compile per config;
    # test_epoch_jitted_end_to_end covers the compiled path once.
    prob, params, solver, state = build(rng, row_pad=row_pad, **cfg)
    ref_params = oracle.oracle_epoch(prob, params)
    with jax.disable_jit():
        state2 = solver.epoch(state)
    for f12 in ref_params["W"]:
        np.testing.assert_allclose(
            np.asarray(state2["params"][f12]["W"]), ref_params["W"][f12],
            rtol=1e-6, atol=1e-9, err_msg=f"W block {f12}",
        )
        np.testing.assert_allclose(
            np.asarray(state2["params"][f12]["H"]), ref_params["H"][f12],
            rtol=1e-6, atol=1e-9, err_msg=f"H block {f12}",
        )


def test_epoch_jitted_end_to_end(rng):
    """One config through the real jitted epoch — compile + numerics."""
    prob, params, solver, state = build(rng)
    ref_params = oracle.oracle_epoch(prob, params)
    state2 = solver.epoch(state)
    for f12 in ref_params["W"]:
        np.testing.assert_allclose(
            np.asarray(state2["params"][f12]["W"]), ref_params["W"][f12],
            rtol=1e-6, atol=1e-9,
        )


def test_caches_consistent_after_epochs(rng):
    """After several epochs the carried caches must equal a fresh rebuild."""
    prob, params, solver, state = build(rng)
    with jax.disable_jit():
        for _ in range(3):
            state = solver.epoch(state)
    fresh = solver.refresh_caches({"params": state["params"]})
    np.testing.assert_allclose(
        np.asarray(state["a"]), np.asarray(fresh["a"]), rtol=1e-8, atol=1e-10
    )
    np.testing.assert_allclose(
        np.asarray(state["b"]), np.asarray(fresh["b"]), rtol=1e-8, atol=1e-10
    )
    w = np.asarray(solver.data["pos_w"])
    np.testing.assert_allclose(
        np.asarray(state["yt"]) * w, np.asarray(fresh["yt"]) * w,
        rtol=1e-8, atol=1e-10,
    )


def test_objective_decreases_over_epochs(rng):
    prob, params, solver, state = build(rng)
    with jax.disable_jit():
        losses = [float(solver.objective(state))]
        for _ in range(5):
            state = solver.epoch(state)
            losses.append(float(solver.objective(state)))
    assert losses[-1] < losses[0]
    # Gauss-Newton on an exactly quadratic subproblem: monotone decrease.
    for prev, nxt in zip(losses, losses[1:]):
        assert nxt <= prev + 1e-9


def test_identity_field_shortcut_matches_general_path(rng):
    """A strict identity-encoded field (Xu[0] = I) must take the
    project/scatter shortcut and produce bit-equal epochs vs the general
    gather/scatter path (flags stripped)."""
    import dataclasses

    import numpy as np

    from conftest import (
        make_problem, oracle_params_to_jax, to_device_problem,
    )
    from one_class_ffm_tpu.solver.jax_solver import FFMSolver

    m, n = 11, 7
    prob, params = make_problem(rng, m=m, n=n, Du=(m, 5), Dv=(n, 4))
    # make field 0 on both sides strict identity encodings
    prob.Xu[0][:] = np.eye(m)
    prob.Xv[0][:] = np.eye(n)
    prob.freq_u[0][:] = 1.0
    prob.freq_v[0][:] = 1.0
    meta, data = to_device_problem(prob, row_pad=1)
    assert meta.ident_u[0] and meta.ident_v[0]
    assert not meta.ident_u[1] and not meta.ident_v[1]

    meta_gen = dataclasses.replace(meta, ident_u=(), ident_v=())
    s_id = FFMSolver(meta, data)
    s_gen = FFMSolver(meta_gen, dict(data))
    st_id = s_id.refresh_caches({"params": oracle_params_to_jax(params)})
    st_gen = s_gen.refresh_caches({"params": oracle_params_to_jax(params)})
    for _ in range(2):
        st_id = s_id.epoch(st_id)
        st_gen = s_gen.epoch(st_gen)
    for f12 in st_gen["params"]:
        for name in ("W", "H"):
            np.testing.assert_allclose(
                np.asarray(st_id["params"][f12][name]),
                np.asarray(st_gen["params"][f12][name]),
                rtol=1e-12, atol=1e-14,
            )
    np.testing.assert_allclose(
        float(s_id.objective(st_id)), float(s_gen.objective(st_gen)),
        rtol=1e-12,
    )
    # oracle gate: the shortcut epoch still matches the fp64 oracle
    from one_class_ffm_tpu.solver.oracle import objective as oracle_obj

    obj = oracle_obj(
        prob,
        {"W": {f: np.asarray(st_id["params"][f]["W"]) for f in st_gen["params"]},
         "H": {f: np.asarray(st_id["params"][f]["H"]) for f in st_gen["params"]}},
    )
    np.testing.assert_allclose(float(s_id.objective(st_id)), obj, rtol=1e-8)


def test_identity_shortcut_with_padded_tables(rng):
    """Identity shortcut composes with d_multiple table padding: the masked
    slice must drop data-pad-row omega terms (nonzero in Z) exactly."""
    import dataclasses

    import numpy as np

    from conftest import (
        make_problem, oracle_params_to_jax, to_device_problem,
    )
    from one_class_ffm_tpu.solver.jax_solver import FFMSolver

    m, n = 10, 6
    prob, params = make_problem(rng, m=m, n=n, Du=(m, 5), Dv=(n, 4))
    prob.Xu[0][:] = np.eye(m)
    prob.Xv[0][:] = np.eye(n)
    prob.freq_u[0][:] = 1.0
    prob.freq_v[0][:] = 1.0
    meta, data = to_device_problem(prob, row_pad=2, d_multiple=8)
    assert meta.ident_u[0]
    meta_gen = dataclasses.replace(meta, ident_u=(), ident_v=())

    def pad_p(params):
        out = {}
        for f12 in params["W"]:
            out[f12] = {}
            for nm in ("W", "H"):
                t = np.asarray(params[nm][f12])
                dp = meta.pad_d(t.shape[0])
                out[f12][nm] = jnp.asarray(
                    np.pad(t, [(0, dp - t.shape[0]), (0, 0)])
                )
        return out

    import jax.numpy as jnp

    s_id = FFMSolver(meta, data)
    s_gen = FFMSolver(meta_gen, dict(data))
    st_id = s_id.epoch(s_id.refresh_caches({"params": pad_p(params)}))
    st_gen = s_gen.epoch(s_gen.refresh_caches({"params": pad_p(params)}))
    for f12 in st_gen["params"]:
        for name in ("W", "H"):
            got = np.asarray(st_id["params"][f12][name])
            ref = np.asarray(st_gen["params"][f12][name])
            np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("cfg", [dict(), dict(self_side=False), dict(freq=True)])
def test_diag_hessian_matches_numeric(rng, cfg):
    """Oracle diag_hessian == diagonal extracted from the hv operator."""
    prob, params, solver, state = build(rng, **cfg)
    for b in prob.layout.all_blocks():
        for first in (True, False):
            _, hv = oracle.grad_and_hv(prob, params, b, first)
            D = oracle.diag_hessian(prob, params, b, first)
            dim, k = D.shape
            num = np.zeros_like(D)
            for di in range(dim):
                for l in range(k):
                    E = np.zeros((dim, k))
                    E[di, l] = 1.0
                    num[di, l] = hv(E)[di, l]
            np.testing.assert_allclose(
                D, num, rtol=1e-9, atol=1e-12,
                err_msg=f"block {b} first={first}",
            )


@pytest.mark.parametrize("cfg", [dict(), dict(self_side=False), dict(freq=True)])
@pytest.mark.parametrize("row_pad", [0, 3])
def test_solver_diag_matches_oracle(rng, cfg, row_pad):
    """JAX _diag_H (sparse/COO path) == oracle brute-force diagonal."""
    prob, params, solver, state = build(rng, row_pad=row_pad, **cfg)
    for b in prob.layout.all_blocks():
        for first in (True, False):
            D_ref = oracle.diag_hessian(prob, params, b, first)
            D = np.asarray(solver._diag_H(state, b, first))[: D_ref.shape[0]]
            np.testing.assert_allclose(
                D, D_ref, rtol=1e-8, atol=1e-10,
                err_msg=f"block {b} first={first}",
            )


def test_cg_precond_auto_resolution(rng):
    """auto -> PLAIN CG (the reference's exact solver) since round 5: the
    sweep tier measured Jacobi-PCG distorting converged-state quality
    under the reference's capped/loose solves (-7.7% p@5 at the KKBox
    k=64 cell, -51% at k=16 fm-fm--ns; both eliminated exactly by plain
    CG — docs/PARITY.md).  "jacobi" stays an explicit opt-in."""
    import dataclasses

    from conftest import make_problem, to_device_problem
    from one_class_ffm_tpu.solver.jax_solver import FFMSolver

    prob, params = make_problem(rng, cg_precond="auto")
    meta, data = to_device_problem(prob)
    assert FFMSolver(meta, data).cg_precond == "none"
    hpj = dataclasses.replace(meta.hp, cg_precond="jacobi")
    metaj = dataclasses.replace(meta, hp=hpj)
    assert FFMSolver(metaj, data).cg_precond == "jacobi"


@pytest.mark.parametrize("pregather",
                         [False, True, "pre_noyt", "pre_nogap"])
@pytest.mark.parametrize("cfg", [dict(), dict(self_side=False),
                                 dict(cg_precond="none")])
def test_full_epoch_matches_oracle_blocked_u(rng, cfg, pregather,
                                             monkeypatch):
    """Epochs with the u-side blocked-sorted positive ops (one-hot
    block matmuls) must still match the fp64 oracle at 1e-6 — with and
    without the per-solve row pre-gather (gather_blocked_rows), with the
    blocked residual gap (pos_gap_blocked, which rides the pre-gather) on
    and off, and with the slot-order residual carry (OCFFM_BLK_YT, which
    auto-engages when every solve is fully blocked) on and off."""
    monkeypatch.setenv("OCFFM_BLK_PREGATHER", "0" if not pregather else "1")
    # pin the gap/carry envs (not just the variant under test) so the
    # assertions below hold regardless of ambient OCFFM_* settings
    monkeypatch.setenv("OCFFM_BLK_GAP",
                       "0" if pregather == "pre_nogap" else "auto")
    monkeypatch.setenv("OCFFM_BLK_YT",
                       "0" if pregather == "pre_noyt" else "auto")
    prob, params = make_problem(rng, **cfg)
    meta, data = to_device_problem(prob, row_pad=3, blocked_bm=4)
    assert meta.blocked_bm_u == 4, "blocked layout should have applied"
    assert meta.blocked_bm_v == 4
    solver = FFMSolver(meta, data)
    assert solver.pregather_u == bool(pregather)
    assert solver.blk_gap == (pregather != "pre_nogap")
    assert solver.blk_yt == (pregather is True)
    state = solver.refresh_caches({"params": oracle_params_to_jax(params)})
    with jax.disable_jit():
        for _ in range(2):
            ref_params = oracle.oracle_epoch(prob, params)
            params = ref_params
            state = solver.epoch(state)
    for f12 in ref_params["W"]:
        np.testing.assert_allclose(
            np.asarray(state["params"][f12]["W"]), ref_params["W"][f12],
            rtol=1e-6, atol=1e-9, err_msg=f"W block {f12}",
        )
        np.testing.assert_allclose(
            np.asarray(state["params"][f12]["H"]), ref_params["H"][f12],
            rtol=1e-6, atol=1e-9, err_msg=f"H block {f12}",
        )

def test_blk_yt_epoch_matches_stream_epoch(rng, monkeypatch):
    """The slot-order residual carry (OCFFM_BLK_YT) computes exactly the
    stream carry's math: cross gaps and gradient coefficients are the SAME
    floats at permuted positions; self-block updates only reorder per-row
    sums.  After two epochs on a self+cross config the params and residuals
    must agree to fp noise."""
    monkeypatch.setenv("OCFFM_BLK_PREGATHER", "1")
    prob, params = make_problem(rng)  # self blocks + cross blocks

    def run(flag):
        monkeypatch.setenv("OCFFM_BLK_YT", flag)
        meta, data = to_device_problem(prob, row_pad=3, blocked_bm=4)
        solver = FFMSolver(meta, data)
        assert solver.blk_yt == (flag == "1")
        state = solver.refresh_caches(
            {"params": oracle_params_to_jax(params)})
        if flag == "1":
            assert "yt" not in state and "yt_u" in state and "yt_v" in state
        with jax.disable_jit():
            for _ in range(2):
                state = solver.epoch(state)
        return solver, state

    s0, st0 = run("0")
    s1, st1 = run("1")
    for f12 in st0["params"]:
        for t in ("W", "H"):
            np.testing.assert_allclose(
                np.asarray(st1["params"][f12][t]),
                np.asarray(st0["params"][f12][t]),
                rtol=1e-12, atol=1e-14, err_msg=f"{t} block {f12}")
    np.testing.assert_allclose(
        np.asarray(s1.yt_stream(st1)), np.asarray(s0.yt_stream(st0)),
        rtol=1e-12, atol=1e-14)
    # objective reconstructs the stream residual under the slot carry
    np.testing.assert_allclose(float(s1.objective(st1)),
                               float(s0.objective(st0)), rtol=1e-12)
