"""Multi-device sharded training on the virtual 8-device CPU mesh.

The sharded epoch must produce the same parameters as the single-device
epoch (GSPMD partitioning is a pure performance transform) and the outputs
must actually be distributed across the mesh.
"""

import jax
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from conftest import make_problem, oracle_params_to_jax, to_device_problem
from one_class_ffm_tpu.parallel import make_mesh, shard_data, shard_state
from one_class_ffm_tpu.solver.jax_solver import FFMSolver


@pytest.fixture(scope="module")
def eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return jax.devices()[:8]


def build_sharded(rng, n_dev=8, **kw):
    prob, params = make_problem(rng, m=19, n=13, **kw)
    meta, data = to_device_problem(prob, row_pad=1, multiple=n_dev)
    mesh = make_mesh(n_dev)
    solver = FFMSolver(meta, data)
    state0 = solver.refresh_caches({"params": oracle_params_to_jax(params)})

    sdata = shard_data(data, mesh)
    ssolver = FFMSolver(meta, sdata)
    # independent buffers: the epoch donates its input state, and device_put
    # to the same device aliases buffers, so sstate must not share with state0
    sstate = shard_state(
        ssolver.refresh_caches({"params": oracle_params_to_jax(params)}), mesh
    )
    return solver, state0, ssolver, sstate, mesh


@pytest.mark.parametrize("cfg", [dict(), dict(self_side=False)])
def test_sharded_epoch_matches_single_device(rng, eight_devices, cfg):
    solver, state0, ssolver, sstate, mesh = build_sharded(rng, **cfg)
    ref = solver.epoch(state0)
    got = ssolver.epoch(sstate)
    for f12, blk in ref["params"].items():
        np.testing.assert_allclose(
            np.asarray(got["params"][f12]["W"]), np.asarray(blk["W"]),
            rtol=1e-9, atol=1e-11,
        )
        np.testing.assert_allclose(
            np.asarray(got["params"][f12]["H"]), np.asarray(blk["H"]),
            rtol=1e-9, atol=1e-11,
        )
    np.testing.assert_allclose(
        np.asarray(got["a"]), np.asarray(ref["a"]), rtol=1e-9, atol=1e-11
    )


@pytest.mark.parametrize("cfg", [dict(), dict(self_side=False)])
def test_sharded_blocked_epoch_matches_plain(rng, eight_devices, cfg):
    """The shard-aligned blocked path (pad_labels shard_rows= + shard_map-
    local one-hot passes) must produce the same parameters as the plain
    single-device epoch — the whole layout + shard_map machinery is a pure
    performance transform."""
    S, BM = 8, 4
    prob, params = make_problem(rng, m=19, n=13, **cfg)
    meta_p, data_p = to_device_problem(prob, row_pad=1, multiple=S * BM)
    plain = FFMSolver(meta_p, data_p)
    ref = plain.epoch(
        plain.refresh_caches({"params": oracle_params_to_jax(params)}))

    mesh = make_mesh(S)
    meta_b, data_b = to_device_problem(
        prob, row_pad=1, multiple=S * BM, blocked_bm=BM, blocked_shards=S)
    assert meta_b.blocked_shards == S and meta_b.blocked_bm_u == BM
    # the v-side layout is built under shards too — with both layouts the
    # slot-order carry engages and BOTH sides' passes run shard-locally
    assert meta_b.blocked_bm_v == BM
    sdata = shard_data(data_b, mesh)
    ssolver = FFMSolver(meta_b, sdata, mesh=mesh)
    assert ssolver.pregather_u  # mandatory for the shard-local passes
    assert ssolver.blk_yt and ssolver.blk_v_on and ssolver.pregather_v
    sstate = shard_state(
        ssolver.refresh_caches({"params": oracle_params_to_jax(params)}),
        mesh)
    got = ssolver.epoch(sstate)
    for f12, blk in ref["params"].items():
        np.testing.assert_allclose(
            np.asarray(got["params"][f12]["W"]), np.asarray(blk["W"]),
            rtol=1e-6, atol=1e-9,
        )
        np.testing.assert_allclose(
            np.asarray(got["params"][f12]["H"]), np.asarray(blk["H"]),
            rtol=1e-6, atol=1e-9,
        )


def _stream_map(data_aligned, data_plain):
    """Map each aligned-stream position to the plain-stream position of the
    same (u, v) pair (only meaningful at real entries — callers mask)."""
    ua = np.asarray(data_aligned["pos_u"])
    va = np.asarray(data_aligned["pos_v"])
    up = np.asarray(data_plain["pos_u"])
    vp = np.asarray(data_plain["pos_v"])
    n = int(max(int(vp.max()), int(va.max()))) + 1
    keys_p = up.astype(np.int64) * n + vp
    keys_a = ua.astype(np.int64) * n + va
    order = np.argsort(keys_p, kind="stable")
    pos = np.clip(np.searchsorted(keys_p[order], keys_a), 0, len(order) - 1)
    return order[pos]


def test_sharded_outputs_stay_distributed(rng, eight_devices):
    solver, state0, ssolver, sstate, mesh = build_sharded(rng)
    got = ssolver.epoch(sstate)
    # row-carried arrays should remain sharded over the data axis
    a_shard = got["a"].sharding
    assert not a_shard.is_fully_replicated
    # params should be replicated (every device holds the full tables)
    f12 = next(iter(got["params"]))
    assert got["params"][f12]["W"].sharding.is_fully_replicated


def test_sharded_objective_matches(rng, eight_devices):
    solver, state0, ssolver, sstate, mesh = build_sharded(rng)
    ref = float(solver.objective(state0))
    got = float(ssolver.objective(sstate))
    np.testing.assert_allclose(got, ref, rtol=1e-9)


def test_2d_mesh_model_sharded_tables(rng, eight_devices):
    """2x4 mesh: rows on 'data', big tables row-sharded on 'model'; the
    epoch must still match single-device execution."""
    from one_class_ffm_tpu.parallel.mesh import make_mesh2

    prob, params = make_problem(rng, m=19, n=13, Du=(8, 4), Dv=(8, 4))
    meta, data = to_device_problem(prob, row_pad=1, multiple=2)
    mesh2 = make_mesh2(2, 4)

    solver = FFMSolver(meta, data)
    ref = solver.epoch(
        solver.refresh_caches({"params": oracle_params_to_jax(params)})
    )

    sdata = shard_data(data, mesh2)
    ssolver = FFMSolver(meta, sdata)
    sstate = shard_state(
        ssolver.refresh_caches({"params": oracle_params_to_jax(params)}),
        mesh2,
        model_min_rows=5,  # tiny threshold so several tables actually shard
    )
    f12_big = max(
        sstate["params"], key=lambda f: sstate["params"][f]["W"].shape[0]
    )
    assert not sstate["params"][f12_big]["W"].sharding.is_fully_replicated
    got = ssolver.epoch(sstate)
    for f12, blk in ref["params"].items():
        np.testing.assert_allclose(
            np.asarray(got["params"][f12]["W"]), np.asarray(blk["W"]),
            rtol=1e-9, atol=1e-11,
        )
        np.testing.assert_allclose(
            np.asarray(got["params"][f12]["H"]), np.asarray(blk["H"]),
            rtol=1e-9, atol=1e-11,
        )


def _pad_params(params, meta):
    """Oracle params -> jax params with table rows padded to meta.d_multiple
    (pad rows zero, the invariant the solver maintains)."""
    import jax.numpy as jnp

    out = {}
    for f12 in params["W"]:
        out[f12] = {}
        for name in ("W", "H"):
            t = np.asarray(params[name][f12])
            dp = meta.pad_d(t.shape[0])
            out[f12][name] = jnp.asarray(
                np.pad(t, [(0, dp - t.shape[0]), (0, 0)])
            )
    return out


def test_padded_tables_match_unpadded(rng):
    """d_multiple table padding is a pure layout transform: true rows evolve
    identically and pad rows stay exactly zero through epochs."""
    prob, params = make_problem(rng, m=12, n=9, Du=(13, 5), Dv=(7, 4))
    meta_u, data_u = to_device_problem(prob)
    meta_p, data_p = to_device_problem(prob, d_multiple=8)
    s_u = FFMSolver(meta_u, data_u)
    s_p = FFMSolver(meta_p, data_p)
    st_u = s_u.refresh_caches({"params": oracle_params_to_jax(params)})
    st_p = s_p.refresh_caches({"params": _pad_params(params, meta_p)})
    for _ in range(2):
        st_u = s_u.epoch(st_u)
        st_p = s_p.epoch(st_p)
    for b in prob.layout.all_blocks():
        for name, d_true in (("W", b.d1), ("H", b.d2)):
            got = np.asarray(st_p["params"][b.f12][name])
            ref = np.asarray(st_u["params"][b.f12][name])
            np.testing.assert_allclose(got[:d_true], ref, rtol=1e-9, atol=1e-12)
            assert np.all(got[d_true:] == 0.0), f"pad rows moved in {name}[{b.f12}]"
    np.testing.assert_allclose(
        float(s_p.objective(st_p)), float(s_u.objective(st_u)), rtol=1e-9
    )


def test_prime_table_shards_on_model_axis(rng, eight_devices):
    """A prime-dim table (never divisible) row-shards on an 8-way model axis
    once d_multiple pads it — and the epoch still matches single-device."""
    from one_class_ffm_tpu.parallel.mesh import make_mesh2, shard_params_model

    prob, params = make_problem(rng, m=17, n=11, Du=(13, 5), Dv=(11, 4))
    meta, data = to_device_problem(prob, d_multiple=8)
    solver = FFMSolver(meta, data)
    ref = solver.epoch(solver.refresh_caches({"params": _pad_params(params, meta)}))

    mesh = jax.sharding.Mesh(
        np.asarray(jax.devices()[:8]).reshape(1, 8), ("data", "model")
    )
    sdata = shard_data(data, mesh)
    ssolver = FFMSolver(meta, sdata)
    sstate = ssolver.refresh_caches({"params": _pad_params(params, meta)})
    sstate = shard_state(sstate, mesh, model_min_rows=8)
    # the D=13 (padded 16) tables must actually shard, not replicate
    sharded_tables = [
        t
        for blk in sstate["params"].values()
        for t in blk.values()
        if not t.sharding.is_fully_replicated
    ]
    assert sharded_tables, "no table sharded on the model axis"
    got = ssolver.epoch(sstate)
    for b in prob.layout.all_blocks():
        for name in ("W", "H"):
            np.testing.assert_allclose(
                np.asarray(got["params"][b.f12][name]),
                np.asarray(ref["params"][b.f12][name]),
                rtol=1e-9, atol=1e-11,
            )


def test_nondivisible_large_table_raises(rng, eight_devices):
    """The silent replicate-on-nondivisible fallback is gone: large tables
    that don't divide the model axis are a hard error pointing at d_multiple."""
    import jax.numpy as jnp

    from one_class_ffm_tpu.parallel.mesh import make_mesh2, shard_params_model

    mesh = make_mesh2(2, 4)
    params = {0: {"W": jnp.zeros((13, 3)), "H": jnp.zeros((16, 3))}}
    with pytest.raises(ValueError, match="d_multiple"):
        shard_params_model(params, mesh, min_rows=8)


def _eval_setup(rng, m=16, n=8, **kw):
    import jax.numpy as jnp
    from conftest import dense_to_padded, make_problem
    from one_class_ffm_tpu.data.dataset import PaddedFields
    from one_class_ffm_tpu.evalx.jax_eval import Evaluator, make_eval_data

    prob, params = make_problem(rng, m=m, n=n, **kw)
    lay = prob.layout
    pads = [dense_to_padded(X, m) for X in prob.Xu]
    uva = PaddedFields(
        m=m, m_true=m, f=len(prob.Xu), Ds=tuple(X.shape[1] for X in prob.Xu),
        idx=tuple(p[0] for p in pads), val=tuple(p[1] for p in pads),
        freq=tuple(np.ones(X.shape[1]) for X in prob.Xu),
        row_nnz=sum((X != 0).sum(axis=1) for X in prob.Xu).astype(np.int32),
    )
    va_labels = [np.nonzero(prob.pos[i])[0] for i in range(m)]
    popular = np.full(n, 1.0 / n)
    meta, data = make_eval_data(
        uva, va_labels, popular, n_items=n, n_items_true=n, layout=lay,
        dtype=jnp.float64,
    )
    jparams = {
        b.f12: {"W": jnp.asarray(params["W"][b.f12]),
                "H": jnp.asarray(params["H"][b.f12])}
        for b in lay.all_blocks()
    }
    Q = {b.f12: jnp.asarray(prob.Xv[b.fj] @ params["H"][b.f12])
         for b in lay.cross_blocks()}
    bt = jnp.zeros(n, jnp.float64)
    for b in lay.item_self_blocks():
        bt = bt + jnp.sum(
            jnp.asarray(prob.Xv[b.fi] @ params["W"][b.f12])
            * jnp.asarray(prob.Xv[b.fj] @ params["H"][b.f12]), axis=1)
    return meta, data, jparams, Q, bt


def test_item_sharded_evaluator_matches(rng, eight_devices):
    """Catalog sharded over 8 devices: every metric (ladder P@K, nDCG, ploss,
    AUC, cold fallback, tie-breaking) identical to the dense path."""
    meta, data, jparams, Q, bt = _eval_setup(rng, m=16, n=16)
    from one_class_ffm_tpu.evalx.jax_eval import Evaluator

    ev = Evaluator(meta, data, chunk=8)
    ref = ev.validate(jparams, Q, bt)
    sev = ev.shard_items(make_mesh(8))
    got = sev.validate(jparams, Q, bt)
    for key, val in ref.items():
        np.testing.assert_allclose(got[key], val, rtol=1e-10, err_msg=key)


def test_item_sharded_eval_million_item_catalog(rng, eight_devices):
    """The n-scaling path: a 1M-item catalog evaluated item-sharded matches
    the dense reference computed at a small user chunk.  (The dense path
    holds a (chunk, n) score block per chunk — at web-scale n it cannot fit
    device memory; the sharded path holds (chunk, n/n_dev) per device.)"""
    import jax.numpy as jnp
    from one_class_ffm_tpu.evalx.jax_eval import Evaluator, make_eval_data
    from one_class_ffm_tpu.data.dataset import PaddedFields
    from one_class_ffm_tpu.models.blocks import BlockLayout

    m, n, k = 8, 1 << 20, 4
    lay = BlockLayout.make((m,), (n,), self_side=False)  # mf-style
    r = np.random.default_rng(1)
    W = r.normal(size=(m, k))
    H = r.normal(size=(n, k)) * 0.1
    uva = PaddedFields(
        m=m, m_true=m, f=1, Ds=(m,),
        idx=(np.arange(m, dtype=np.int32)[:, None],),
        val=(np.ones((m, 1)),),
        freq=(np.ones(m),),
        row_nnz=np.ones(m, dtype=np.int32),
    )
    va_labels = [r.choice(n, size=5, replace=False) for _ in range(m)]
    popular = r.random(n)
    meta, data = make_eval_data(
        uva, va_labels, popular, n_items=n, n_items_true=n, layout=lay,
        dtype=jnp.float64,
    )
    f12 = lay.cross_blocks()[0].f12
    jparams = {f12: {"W": jnp.asarray(W), "H": jnp.asarray(H)}}
    Q = {f12: jnp.asarray(H)}
    bt = jnp.zeros(n, jnp.float64)
    ev = Evaluator(meta, data, chunk=8)
    ref = ev.validate(jparams, Q, bt)
    sev = ev.shard_items(make_mesh(8))
    got = sev.validate(jparams, Q, bt)
    for key, val in ref.items():
        np.testing.assert_allclose(got[key], val, rtol=1e-9, err_msg=key)
    assert 0.0 < got["auc"] <= 1.0


def test_sharded_evaluator_matches(rng, eight_devices):
    """Evaluator with test users sharded over the mesh == unsharded."""
    import jax.numpy as jnp
    from conftest import dense_to_padded, make_problem
    from one_class_ffm_tpu.data.dataset import PaddedFields
    from one_class_ffm_tpu.evalx.jax_eval import Evaluator, make_eval_data

    prob, params = make_problem(rng, m=16, n=8)
    lay = prob.layout
    m, n = prob.m, prob.n
    pads = [dense_to_padded(X, m) for X in prob.Xu]
    uva = PaddedFields(
        m=m, m_true=m, f=len(prob.Xu), Ds=tuple(X.shape[1] for X in prob.Xu),
        idx=tuple(p[0] for p in pads), val=tuple(p[1] for p in pads),
        freq=tuple(np.ones(X.shape[1]) for X in prob.Xu),
        row_nnz=sum((X != 0).sum(axis=1) for X in prob.Xu).astype(np.int32),
    )
    va_labels = [np.nonzero(prob.pos[i])[0] for i in range(m)]
    popular = np.full(n, 1.0 / n)
    meta, data = make_eval_data(
        uva, va_labels, popular, n_items=n, n_items_true=n, layout=lay,
        dtype=jnp.float64,
    )
    jparams = {
        b.f12: {"W": jnp.asarray(params["W"][b.f12]),
                "H": jnp.asarray(params["H"][b.f12])}
        for b in lay.all_blocks()
    }
    Q = {b.f12: jnp.asarray(prob.Xv[b.fj] @ params["H"][b.f12])
         for b in lay.cross_blocks()}
    bt = jnp.zeros(n, jnp.float64)
    for b in lay.item_self_blocks():
        bt = bt + jnp.sum(
            jnp.asarray(prob.Xv[b.fi] @ params["W"][b.f12])
            * jnp.asarray(prob.Xv[b.fj] @ params["H"][b.f12]), axis=1)

    ev = Evaluator(meta, data, chunk=8)
    ref = ev.validate(jparams, Q, bt)
    sev = ev.shard(make_mesh(8))
    got = sev.validate(jparams, Q, bt)
    for key, val in ref.items():
        np.testing.assert_allclose(got[key], val, rtol=1e-10, err_msg=key)


def test_sharded_epoch_collective_census(rng, eight_devices, monkeypatch):
    """Pin the sharded solve's collective budget in the compiled HLO.  The
    design claim: per half-solve, ONE all-reduce inside the CG loop (the
    table-space reduction of the Hv pass); the B-row all-gather (pregather)
    and the carry's cross-order propagation run OUTSIDE the loop.  A GSPMD
    regression that silently re-shards per CG iteration (e.g. an all-gather
    of the stream inside the while body) multiplies per-iteration
    interconnect traffic and is invisible to correctness tests — catch it
    on CPU by counting collectives per while-body computation."""
    import re

    S, BM = 8, 4
    prob, params = make_problem(rng, m=19, n=13)
    meta_b, data_b = to_device_problem(
        prob, row_pad=1, multiple=S * BM, blocked_bm=BM, blocked_shards=S)
    mesh = make_mesh(S)
    sdata = shard_data(data_b, mesh)
    ssolver = FFMSolver(meta_b, sdata, mesh=mesh)
    assert ssolver.blk_yt and ssolver.pregather_v  # full blocked stack
    sstate = shard_state(
        ssolver.refresh_caches({"params": oracle_params_to_jax(params)}),
        mesh)
    txt = ssolver._epoch.lower(sstate, sdata).compile().as_text()

    n_halves = 2 * len(ssolver.blocks)
    coll_re = re.compile(
        r"(all-reduce|all-gather|all-to-all|collective-permute|"
        r"reduce-scatter)\(")
    # one CG while loop per half-solve survives to the optimized HLO
    bodies = set(re.findall(r"body=%?([\w.\-]+)", txt))
    assert len(bodies) == n_halves

    # collectives per computation block in the HLO text
    comp_colls, cur = {}, None
    for line in txt.splitlines():
        ls = line.strip()
        if ls.endswith("{") and not ls.startswith("//"):
            cur = ls.split()[0].lstrip("%")
            comp_colls[cur] = []
        elif ls == "}":
            cur = None
        elif cur is not None:
            m = coll_re.search(ls)
            if m:
                comp_colls[cur].append(m.group(1))
    for b in bodies:
        colls = comp_colls.get(b, [])
        # exactly the designed per-iteration collective: one all-reduce
        # (the table-space reduction) — and NEVER an all-gather
        assert colls == ["all-reduce"], (b, colls)

    # whole-epoch totals stay within the documented budget (generous
    # bounds — compiler-version drift in CSE/fusion must not flake this)
    totals = {k: 0 for k in ("all-reduce", "all-gather", "all-to-all",
                             "collective-permute", "reduce-scatter")}
    for colls in comp_colls.values():
        for c in colls:
            totals[c] += 1
    assert totals["all-gather"] <= 2 * n_halves, totals
    assert totals["all-reduce"] <= 4 * n_halves, totals
    assert totals["all-to-all"] == 0 and totals["collective-permute"] == 0, \
        totals
