"""Sparse op implementations agree with their plain references."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from one_class_ffm_tpu.ops.sparse_ops import project, scatter


def test_dispatcher_cpu_uses_xla(rng):
    """project == the dense X @ W it stands for (f64; repeated indices in
    a row add up)."""
    m, p, d, k = 16, 2, 8, 4
    idx = rng.integers(0, d, size=(m, p))
    val = rng.random((m, p))
    W = rng.random((d, k))
    X = np.zeros((m, d))
    np.add.at(X, (np.arange(m)[:, None], idx), val)
    got = project(jnp.asarray(idx, jnp.int32), jnp.asarray(val),
                  jnp.asarray(W))
    np.testing.assert_allclose(np.asarray(got), X @ W, rtol=1e-12)


@pytest.mark.parametrize("op", ["scatter", "pos_scatter"])
def test_bf16_scatters_accumulate_in_f32(rng, op):
    """bf16 scatter-adds accumulate at an f32 floor and round once: the
    result equals the f32 scatter of the same bf16 inputs, rounded."""
    from one_class_ffm_tpu.ops import sparse_ops as ops

    m, n, k = 8, 300, 4
    seg = jnp.asarray(rng.integers(0, m, size=n), jnp.int32)
    Z = jnp.asarray(rng.normal(size=(n, k)), jnp.bfloat16)
    # unit weights: every product is exact, so only the accumulation differs
    if op == "scatter":
        def run(z):
            return ops.scatter(seg[:, None], jnp.ones((n, 1), z.dtype), z, m)
    else:
        def run(z):
            return ops.pos_scatter(jnp.ones(n, z.dtype), z, jnp.arange(n),
                                   seg, m, max_chunk=64)
    got = run(Z)
    ref = run(Z.astype(jnp.float32)).astype(jnp.bfloat16)
    assert got.dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(got, np.float32),
                                  np.asarray(ref, np.float32))


def test_scatter_transpose_consistency(rng):
    """scatter is the adjoint of project: <P, Z> == <W, scatter(Z)>."""
    m, p, d, k = 32, 3, 16, 4
    idx = jnp.asarray(rng.integers(0, d, size=(m, p)), jnp.int32)
    val = jnp.asarray(rng.random((m, p)), jnp.float64)
    W = jnp.asarray(rng.random((d, k)), jnp.float64)
    Z = jnp.asarray(rng.random((m, k)), jnp.float64)
    lhs = float(jnp.sum(project(idx, val, W) * Z))
    rhs = float(jnp.sum(W * scatter(idx, val, Z, d)))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-12)


def test_pos_ops_chunked_match_direct(rng):
    import jax.numpy as jnp

    from one_class_ffm_tpu.ops.sparse_ops import pos_dot, pos_scatter

    m, n, k, nnz = 23, 17, 5, 101
    A = jnp.asarray(rng.normal(size=(m, k)))
    B = jnp.asarray(rng.normal(size=(n, k)))
    u = jnp.asarray(rng.integers(0, m, size=nnz), jnp.int32)
    v = jnp.asarray(rng.integers(0, n, size=nnz), jnp.int32)
    w = jnp.asarray(rng.random(nnz))

    # atol for near-cancellation sums: XLA may reassociate across branches
    ref_dot = pos_dot(A, u, B, v, max_chunk=nnz + 1)
    got_dot = pos_dot(A, u, B, v, max_chunk=16)  # forces the chunked branch
    np.testing.assert_allclose(
        np.asarray(got_dot), np.asarray(ref_dot), rtol=1e-12, atol=1e-12
    )

    ref_sc = pos_scatter(w, B, v, u, m, max_chunk=nnz + 1)
    got_sc = pos_scatter(w, B, v, u, m, max_chunk=16)
    np.testing.assert_allclose(
        np.asarray(got_sc), np.asarray(ref_sc), rtol=1e-12, atol=1e-12
    )


def test_solver_matches_oracle_with_tiny_chunks(rng, monkeypatch):
    """Full epoch under forced chunking must still match the oracle."""
    import one_class_ffm_tpu.ops.sparse_ops as so
    from conftest import make_problem, oracle_params_to_jax, to_device_problem
    from one_class_ffm_tpu.solver import oracle
    from one_class_ffm_tpu.solver.jax_solver import FFMSolver

    monkeypatch.setattr(so, "_NNZ_CHUNK", 7)
    prob, params = make_problem(rng)
    meta, data = to_device_problem(prob)
    solver = FFMSolver(meta, data)
    state = solver.refresh_caches({"params": oracle_params_to_jax(params)})
    ref = oracle.oracle_epoch(prob, params)
    got = solver.epoch(state)
    for f12 in ref["W"]:
        np.testing.assert_allclose(
            np.asarray(got["params"][f12]["W"]), ref["W"][f12],
            rtol=1e-6, atol=1e-9,
        )


def test_pos_gram_matches_naive(rng):
    """pos_gram == naive per-row sum of w * outer(B_t, B_t); chunked too."""
    from one_class_ffm_tpu.ops.sparse_ops import pos_gram

    m, n, k, nnz = 19, 13, 4, 97
    B = jnp.asarray(rng.normal(size=(n, k)))
    own = np.asarray(rng.integers(0, m, size=nnz), np.int32)
    other = np.asarray(rng.integers(0, n, size=nnz), np.int32)
    w = np.asarray(rng.random(nnz))

    naive = np.zeros((m, k * k))
    Bn = np.asarray(B)
    for t in range(nnz):
        naive[own[t]] += w[t] * np.outer(Bn[other[t]], Bn[other[t]]).ravel()

    got = pos_gram(jnp.asarray(w), B, jnp.asarray(other), jnp.asarray(own),
                   m, max_chunk=nnz + 1)
    np.testing.assert_allclose(np.asarray(got), naive, rtol=1e-10, atol=1e-10)
    chunked = pos_gram(jnp.asarray(w), B, jnp.asarray(other), jnp.asarray(own),
                       m, max_chunk=16)
    np.testing.assert_allclose(np.asarray(chunked), naive,
                               rtol=1e-10, atol=1e-10)



def test_pos_scatter_pair_matches_two_scatters(rng):
    """Fused (chunk, 2k) pass == two independent pos_scatter calls."""
    from one_class_ffm_tpu.ops.sparse_ops import pos_scatter, pos_scatter_pair

    m, n, k, nnz = 23, 17, 5, 101
    B = jnp.asarray(rng.normal(size=(n, k)))
    take = jnp.asarray(rng.integers(0, n, size=nnz), jnp.int32)
    seg = jnp.asarray(rng.integers(0, m, size=nnz), jnp.int32)
    wa = jnp.asarray(rng.random(nnz))
    wb = jnp.asarray(rng.random(nnz))

    ref_a = pos_scatter(wa, B, take, seg, m)
    ref_b = pos_scatter(wb, B * B, take, seg, m)
    for chunk in (nnz + 1, 16):  # direct + chunked branches
        got_a, got_b = pos_scatter_pair(wa, wb, B, take, seg, m,
                                        max_chunk=chunk)
        np.testing.assert_allclose(np.asarray(got_a), np.asarray(ref_a),
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(np.asarray(got_b), np.asarray(ref_b),
                                   rtol=1e-12, atol=1e-12)


def test_blocked_layout_and_ops_match_pos_ops(rng):
    """Blocked-sorted ops == pos_scatter / pos_dot+pos_scatter on a sorted
    stream (f64 tight), including the fused diag payload."""
    from one_class_ffm_tpu.ops.sparse_ops import (
        make_blocked_layout,
        pos_dot,
        pos_hv_blocked,
        pos_scatter,
        pos_scatter_blocked,
    )

    num, n_other, k, nnz, BM = 24, 11, 5, 93, 4
    u = np.sort(rng.integers(0, num, size=nnz)).astype(np.int32)
    v = rng.integers(0, n_other, size=nnz).astype(np.int32)
    blk = make_blocked_layout(u, v, num, block_rows=BM, max_pad_ratio=50.0)
    assert blk is not None

    B = jnp.asarray(rng.normal(size=(n_other, k)))
    phi = jnp.asarray(rng.normal(size=(num, k)))
    coeff = jnp.asarray(rng.random(nnz))
    wq = jnp.asarray(rng.random(nnz))
    take = jnp.asarray(blk["take"])
    src = jnp.asarray(blk["src"])
    own = jnp.asarray(blk["own"])

    ref = pos_scatter(coeff, B, jnp.asarray(v), jnp.asarray(u), num,
                      seg_sorted=True)
    got = pos_scatter_blocked(coeff, B, take, src, own, num, BM)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-10, atol=1e-12)

    got2, gotq = pos_scatter_blocked(coeff, B, take, src, own, num, BM,
                                     diag_w=wq)
    refq = pos_scatter(wq, B * B, jnp.asarray(v), jnp.asarray(u), num,
                       seg_sorted=True)
    np.testing.assert_allclose(np.asarray(got2), np.asarray(ref),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np.asarray(gotq), np.asarray(refq),
                               rtol=1e-10, atol=1e-12)

    w = jnp.asarray(rng.random(nnz))
    pq = pos_dot(phi, jnp.asarray(u), B, jnp.asarray(v)) * w
    ref_hv = pos_scatter(pq, B, jnp.asarray(v), jnp.asarray(u), num,
                         seg_sorted=True)
    got_hv = pos_hv_blocked(phi, B, w, take, src, own, num, BM)
    np.testing.assert_allclose(np.asarray(got_hv), np.asarray(ref_hv),
                               rtol=1e-10, atol=1e-12)


def test_blocked_pregather_rows_match(rng):
    """Blocked ops fed pre-gathered rows (gather_blocked_rows) are bit-equal
    to the gather-inside form: same adds in the same order, only the gather
    is hoisted."""
    from one_class_ffm_tpu.ops.sparse_ops import (
        gather_blocked_rows,
        make_blocked_layout,
        pos_hv_blocked,
        pos_scatter_blocked,
    )

    num, n_other, k, nnz, BM = 24, 11, 5, 93, 4
    u = np.sort(rng.integers(0, num, size=nnz)).astype(np.int32)
    v = rng.integers(0, n_other, size=nnz).astype(np.int32)
    blk = make_blocked_layout(u, v, num, block_rows=BM, max_pad_ratio=50.0)
    B = jnp.asarray(rng.normal(size=(n_other, k)))
    phi = jnp.asarray(rng.normal(size=(num, k)))
    coeff = jnp.asarray(rng.random(nnz))
    wq = jnp.asarray(rng.random(nnz))
    take = jnp.asarray(blk["take"])
    src = jnp.asarray(blk["src"])
    own = jnp.asarray(blk["own"])

    rows = gather_blocked_rows(B, take)
    assert rows.shape == (take.shape[0], take.shape[1], k)

    ref, refq = pos_scatter_blocked(coeff, B, take, src, own, num, BM,
                                    diag_w=wq)
    got, gotq = pos_scatter_blocked(coeff, B, take, src, own, num, BM,
                                    diag_w=wq, rows=rows)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
    np.testing.assert_array_equal(np.asarray(gotq), np.asarray(refq))

    ref_hv = pos_hv_blocked(phi, B, wq, take, src, own, num, BM)
    got_hv = pos_hv_blocked(phi, B, wq, take, src, own, num, BM, rows=rows)
    np.testing.assert_array_equal(np.asarray(got_hv), np.asarray(ref_hv))


def test_blocked_hv_w_blk_and_dense_fusion(rng):
    """The pre-permuted weight path (w_blk) is bit-equal to the w[src] form
    ((s*w)[src] == w[src]*s exactly); the fused dense term (dense_mat)
    matches dense + zp to f32 tolerance (f32 accumulation, one cast)."""
    from one_class_ffm_tpu.ops.sparse_ops import (
        make_blocked_layout,
        pos_hv_blocked,
    )

    num, n_other, k, nnz, BM = 24, 11, 5, 93, 4
    scale = 0.9
    u = np.sort(rng.integers(0, num, size=nnz)).astype(np.int32)
    v = rng.integers(0, n_other, size=nnz).astype(np.int32)
    blk = make_blocked_layout(u, v, num, block_rows=BM, max_pad_ratio=50.0)
    B = jnp.asarray(rng.normal(size=(n_other, k)))
    phi = jnp.asarray(rng.normal(size=(num, k)))
    w_raw = jnp.asarray(rng.random(nnz))
    take, src, own = (jnp.asarray(blk[s]) for s in ("take", "src", "own"))
    w_blk = w_raw[jnp.asarray(blk["src"])]

    ref = pos_hv_blocked(phi, B, scale * w_raw, take, src, own, num, BM)
    got = pos_hv_blocked(phi, B, None, take, src, own, num, BM,
                         w_blk=w_blk, w_scale=scale)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))

    dmat = jnp.asarray(rng.normal(size=(k, k)))
    fused = pos_hv_blocked(phi, B, None, take, src, own, num, BM,
                           w_blk=w_blk, w_scale=scale, dense_mat=dmat)
    np.testing.assert_allclose(np.asarray(fused), np.asarray(ref + phi @ dmat),
                               rtol=1e-6, atol=1e-6)


def test_blocked_layout_rejections(rng):
    from one_class_ffm_tpu.ops.sparse_ops import make_blocked_layout

    u = np.sort(rng.integers(0, 24, size=50)).astype(np.int32)
    v = rng.integers(0, 7, size=50).astype(np.int32)
    assert make_blocked_layout(u, v, 25, block_rows=4) is None  # 25 % 4
    # skew guard: one row owns everything -> MAXC blows the pad ratio
    u2 = np.zeros(50, np.int32)
    assert make_blocked_layout(u2, v, 1024, 4, max_pad_ratio=2.0) is None


def test_blocked_layout_unsorted_segment_side(rng):
    """An UNSORTED segment side (the v side of the u-major stream) is
    argsorted inside the builder; the blocked scatter must still equal
    pos_scatter on the original stream."""
    from one_class_ffm_tpu.ops.sparse_ops import (
        make_blocked_layout, pos_scatter, pos_scatter_blocked,
    )

    num, n_other, k, nnz, BM = 20, 9, 4, 77, 4
    seg = rng.integers(0, num, size=nnz).astype(np.int32)  # unsorted
    take_ids = rng.integers(0, n_other, size=nnz).astype(np.int32)
    blk = make_blocked_layout(seg, take_ids, num, BM, max_pad_ratio=50.0)
    assert blk is not None
    B = jnp.asarray(rng.normal(size=(n_other, k)))
    coeff = jnp.asarray(rng.random(nnz))
    ref = pos_scatter(coeff, B, jnp.asarray(take_ids), jnp.asarray(seg), num)
    got = pos_scatter_blocked(coeff, B, jnp.asarray(blk["take"]),
                              jnp.asarray(blk["src"]),
                              jnp.asarray(blk["own"]), num, BM)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-10, atol=1e-12)


def test_blocked_mixed_dispatch_under_skew(rng):
    """Head-heavy item popularity: the v-side layout must self-reject (one
    popular item's block sets MAXC for all) while the u-side stays blocked;
    the solver runs the resulting MIXED dispatch and still matches the
    plain path."""
    import jax

    from one_class_ffm_tpu.data.synth import SynthSpec, build_padded
    from one_class_ffm_tpu.models.blocks import BlockLayout
    from one_class_ffm_tpu.solver.jax_solver import (
        FFMSolver, make_device_data,
    )
    from one_class_ffm_tpu.solver.params import HyperParams

    spec = SynthSpec(n_users=512, n_items=128, avg_pos=6.0, seed=2,
                     dims_u=(512, 64), dims_v=(128, 32), pop_skew=2.5)
    (du, dv), u_pad, v_pad, y_pad = build_padded(spec, dtype=np.float32,
                                                 row_multiple=16)
    layout = BlockLayout.make(du, dv, self_side=True)
    hp = HyperParams(k=4, lam=0.05, omega=0.1, r=-1.0)
    meta_b, data_b = make_device_data(u_pad, v_pad, y_pad, layout, hp,
                                      dtype=jnp.float64, blocked_bm=16)
    assert meta_b.blocked_bm_u == 16  # user side stays blocked
    assert meta_b.blocked_bm_v == 0  # item side rejected by the skew guard

    meta_p, data_p = make_device_data(u_pad, v_pad, y_pad, layout, hp,
                                      dtype=jnp.float64)
    sb, sp = FFMSolver(meta_b, data_b), FFMSolver(meta_p, data_p)
    st_b = sb.init(jax.random.key(0))
    st_p = sp.init(jax.random.key(0))
    for _ in range(2):
        st_b = sb.epoch(st_b)
        st_p = sp.epoch(st_p)
    for f12 in st_p["params"]:
        np.testing.assert_allclose(
            np.asarray(st_b["params"][f12]["W"]),
            np.asarray(st_p["params"][f12]["W"]), rtol=1e-9, atol=1e-11)


def test_pos_gap_blocked_matches_pos_dot(rng):
    """The blocked residual gap (one-hot gather + sequential stream +
    static inverse permute) equals the plain pos_dot "gaps" form on every
    kept entry, on both segment sides (sorted u, argsorted v), with dropped
    zero-weight pads excluded (their slots return arbitrary values that the
    caller's pad-weight multiply kills)."""
    from one_class_ffm_tpu.ops.sparse_ops import (
        gather_blocked_rows,
        make_blocked_layout,
        pos_dot,
        pos_gap_blocked,
    )

    m, n, k, nnz, BM = 24, 16, 5, 93, 4
    u = np.sort(rng.integers(0, m, size=nnz)).astype(np.int32)
    v = rng.integers(0, n, size=nnz).astype(np.int32)
    w = (rng.random(nnz) > 0.2).astype(np.float64)  # some dropped pads
    dP = jnp.asarray(rng.normal(size=(m, k)))
    B = jnp.asarray(rng.normal(size=(n, k)))

    for seg, take, num, dT, Bt in ((u, v, m, dP, B), (v, u, n, B, dP)):
        blk = make_blocked_layout(seg, take, num, block_rows=BM,
                                  max_pad_ratio=50.0, drop=(w == 0))
        assert blk is not None
        rows = gather_blocked_rows(Bt, jnp.asarray(blk["take"]))
        got = pos_gap_blocked(dT, rows, jnp.asarray(blk["own"]),
                              jnp.asarray(blk["inv"]), BM)
        ref = pos_dot(dT, jnp.asarray(seg), Bt, jnp.asarray(take))
        np.testing.assert_allclose(np.asarray(got) * w, np.asarray(ref) * w,
                                   rtol=1e-10, atol=1e-12)


def test_blocked_scatter_diag_w_blk_bit_equal(rng):
    """diag_w_blk (pre-permuted static diag weights) is bit-equal to the
    diag_w[src] gather form — same float pairs multiply."""
    from one_class_ffm_tpu.ops.sparse_ops import (
        make_blocked_layout,
        pos_scatter_blocked,
    )

    num, n_other, k, nnz, BM = 24, 11, 5, 93, 4
    u = np.sort(rng.integers(0, num, size=nnz)).astype(np.int32)
    v = rng.integers(0, n_other, size=nnz).astype(np.int32)
    blk = make_blocked_layout(u, v, num, block_rows=BM, max_pad_ratio=50.0)
    B = jnp.asarray(rng.normal(size=(n_other, k)))
    coeff = jnp.asarray(rng.random(nnz))
    wq = jnp.asarray(rng.random(nnz))
    take = jnp.asarray(blk["take"])
    src = jnp.asarray(blk["src"])
    own = jnp.asarray(blk["own"])

    ref, refq = pos_scatter_blocked(coeff, B, take, src, own, num, BM,
                                    diag_w=wq)
    got, gotq = pos_scatter_blocked(coeff, B, take, src, own, num, BM,
                                    diag_w_blk=wq[src])
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
    np.testing.assert_array_equal(np.asarray(gotq), np.asarray(refq))


def test_blocked_scatter_coeff_blk_bit_equal(rng):
    """coeff_blk (coefficients already in slot order, the OCFFM_BLK_YT form)
    is bit-equal to the coeff[src] gather form — same floats, same matmuls."""
    from one_class_ffm_tpu.ops.sparse_ops import (
        make_blocked_layout,
        pos_scatter_blocked,
    )

    num, n_other, k, nnz, BM = 24, 11, 5, 93, 4
    u = np.sort(rng.integers(0, num, size=nnz)).astype(np.int32)
    v = rng.integers(0, n_other, size=nnz).astype(np.int32)
    blk = make_blocked_layout(u, v, num, block_rows=BM, max_pad_ratio=50.0)
    B = jnp.asarray(rng.normal(size=(n_other, k)))
    coeff = rng.random(nnz)
    take = jnp.asarray(blk["take"])
    src = jnp.asarray(blk["src"])
    own = jnp.asarray(blk["own"])

    ref = pos_scatter_blocked(jnp.asarray(coeff), B, take, src, own, num, BM)
    got = pos_scatter_blocked(None, B, take, None, own, num, BM,
                              coeff_blk=jnp.asarray(coeff[blk["src"]]))
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_seg_sum_and_expand_blocked(rng):
    """seg_sum_blocked == segment_sum over kept entries; expand_rows_blocked
    == vec[seg_id] at kept slots and exactly 0 at structural pads — the two
    sequential-streaming primitives the slot-order residual carry uses for
    self-block updates."""
    from one_class_ffm_tpu.ops.sparse_ops import (
        expand_rows_blocked,
        make_blocked_layout,
        seg_sum_blocked,
    )

    m, nnz, BM = 24, 93, 4
    u = np.sort(rng.integers(0, m, size=nnz)).astype(np.int32)
    v = rng.integers(0, 16, size=nnz).astype(np.int32)
    w = (rng.random(nnz) > 0.2).astype(np.float64)  # some dropped entries
    blk = make_blocked_layout(u, v, m, block_rows=BM, max_pad_ratio=50.0,
                              drop=(w == 0))
    assert blk is not None
    own = jnp.asarray(blk["own"])
    msk = (blk["own"] < BM).astype(np.float64)

    c = rng.normal(size=nnz)
    c_blk = jnp.asarray(c[blk["src"]] * msk)
    got = seg_sum_blocked(c_blk, own, m, BM)
    ref = np.zeros(m)
    np.add.at(ref, u[w > 0], c[w > 0])
    np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-12, atol=1e-14)

    vec = rng.normal(size=m)
    got2 = expand_rows_blocked(jnp.asarray(vec), own, BM)
    ref2 = (vec[u[blk["src"]]] * msk).reshape(-1)
    np.testing.assert_allclose(np.asarray(got2), ref2, rtol=1e-12, atol=0)


def test_solver_perf_gates(rng, monkeypatch):
    """The performance-gate decisions (pregather caps, the device-memory
    budget, mesh fallback, two-tier engagement) respond to their knobs —
    a regression here silently turns the blocked stream path off."""
    from conftest import make_problem, to_device_problem
    from one_class_ffm_tpu.solver.jax_solver import FFMSolver

    prob, params = make_problem(rng)
    meta, data = to_device_problem(prob, multiple=4, blocked_bm=4)

    s = FFMSolver(meta, data)
    assert s.pregather_u and s.pregather_v  # default: on under the caps
    assert s.blk_yt  # carry auto-engages when both sides pregather

    # per-stream cap turns pregather (and with it the carry) off
    monkeypatch.setenv("OCFFM_BLK_PREGATHER_MB", "0")
    s2 = FFMSolver(meta, data)
    assert not s2.pregather_u and not s2.pregather_v and not s2.blk_yt
    monkeypatch.delenv("OCFFM_BLK_PREGATHER_MB")

    # under a PLAIN mesh (no shard-aligned stream) the blocked stream stays
    # off — the plain GSPMD ops are that mesh path
    import jax
    from jax.sharding import Mesh

    mesh = Mesh(jax.devices()[:2], ("data",))
    s5 = FFMSolver(meta, data, mesh=mesh)
    assert not s5.pregather_u and not s5.blk_yt

    # under the SHARD-ALIGNED mesh the blocked stack stays ON (pregather
    # both sides + carry + blocked gap, shard_map-local)
    S, BM = 2, 4
    prob6, _ = make_problem(rng, m=19, n=13)
    meta6, data6 = to_device_problem(
        prob6, row_pad=1, multiple=S * BM, blocked_bm=BM, blocked_shards=S)
    assert meta6.blocked_bm_u == BM and meta6.blocked_bm_v == BM
    s6 = FFMSolver(meta6, data6, mesh=mesh)
    assert s6.blk_yt and s6.blk_gap
    assert s6.pregather_u and s6.pregather_v and s6.blk_v_on

    # the carry off under shards -> the sharded fallback: u blocked, v plain
    monkeypatch.setenv("OCFFM_BLK_YT", "0")
    s7 = FFMSolver(meta6, data6, mesh=mesh)
    assert not s7.blk_yt
    assert s7.pregather_u and not s7.pregather_v and not s7.blk_v_on
    monkeypatch.delenv("OCFFM_BLK_YT")

    # popularity skew: the two-tier split keeps the v layout (head keys
    # present) and with it the whole blocked stack
    monkeypatch.setenv("OCFFM_HEAD_CHUNK", "8")
    prob8, _ = make_problem(rng, m=40, n=24, density=0.1)
    pos8 = __import__("numpy").asarray(prob8.pos).copy()
    pos8[:, :2] = True  # two power items
    prob8.pos = pos8
    meta8, data8 = to_device_problem(prob8, row_pad=1, multiple=8,
                                     blocked_bm=4)
    s8 = FFMSolver(meta8, data8)
    assert s8.hd_v and "blk_v_hd_row" in data8
    assert s8.blk_yt and s8.pregather_v
    # ... and with the split disabled the side rejects outright
    monkeypatch.setenv("OCFFM_HEAD_CHUNK", "0")
    meta9, data9 = to_device_problem(prob8, row_pad=1, multiple=8,
                                     blocked_bm=4)
    assert meta9.blocked_bm_v == 0 and "blk_v_hd_row" not in data9
    # under a shard-aligned mesh the two-tier split engages too — the tail
    # keeps the shard_map-local passes (carry mode, not the fallback) and
    # the head ops run at jit level, GSPMD-partitioned; an unskewed mesh
    # problem stays single-tier
    monkeypatch.setenv("OCFFM_HEAD_CHUNK", "8")
    meta10, data10 = to_device_problem(prob8, row_pad=1, multiple=S * BM,
                                       blocked_bm=BM, blocked_shards=S)
    assert meta10.blocked_bm_u == BM and meta10.blocked_bm_v == BM
    s10 = FFMSolver(meta10, data10, mesh=mesh)
    assert s10.hd_v and "blk_v_hd_row" in data10
    assert s10.blk_yt and s10.blk_v_on and s10.pregather_v
    monkeypatch.delenv("OCFFM_HEAD_CHUNK")
    assert "blk_u_hd_row" not in data6 and "blk_v_hd_row" not in data6

    # CG degenerate-denominator guard: an f32 V.Hv underflow to 0 (found
    # by the sweep-tier parity run: inf steps -> NaN ploss on 7/10 seeds)
    # must take no step and stop, never write inf/nan
    import jax.numpy as jnp
    s9 = FFMSolver(meta, data)
    G9 = jnp.full((8, 4), 1e-18, jnp.float32)
    for D9 in (None, jnp.ones((8, 4), jnp.float32)):
        S9, it9 = s9._cg(lambda V: V * jnp.float32(1e-25), G9, D9)
        assert bool(jnp.all(jnp.isfinite(S9)))

    # device-memory budget (OCFFM_HBM_GB overrides the device's own
    # bytes_limit; the CPU reports none): ample memory keeps the stack on;
    # the donation-aware model must NOT zero the cap when the state fits;
    # a tiny device zeroes the cap and the stack falls back
    monkeypatch.setenv("OCFFM_HBM_GB", "16")
    s10 = FFMSolver(meta, data)
    assert s10.pregather_u and s10.pregather_v and s10.blk_yt
    assert s10.pregather_cap > 0
    monkeypatch.setenv("OCFFM_HBM_GB", "0.000001")
    s11 = FFMSolver(meta, data)
    assert s11.pregather_cap == 0
    assert not s11.pregather_u and not s11.blk_yt
    monkeypatch.delenv("OCFFM_HBM_GB")


GRAD_HV_CONFIGS = [dict(), dict(self_side=False), dict(freq=True),
                   dict(cg_precond="jacobi")]


def _grad_hv_vs_oracle(rng, cfg, blocked_bm):
    """Worst relative error of FFMSolver.grad_hv (every half-solve's G and
    Hv(G) at one state) against the fp64 oracle: the comparison
    chip_smoke.py runs on the card."""
    from one_class_ffm_tpu.solver import oracle
    from one_class_ffm_tpu.solver.jax_solver import FFMSolver

    kw = dict(cg_precond="none")
    kw.update(cfg)
    prob, params = oracle.make_problem(rng, m=64, n=32, Du=(64, 12),
                                       Dv=(32, 9), k=16, density=0.15, **kw)
    meta, data = oracle.to_device_problem(prob, dtype=np.float32,
                                          multiple=16, blocked_bm=blocked_bm)
    assert (meta.blocked_bm_u > 0) == (blocked_bm > 0)
    solver = FFMSolver(meta, data)
    state = solver.refresh_caches(
        {"params": oracle.oracle_params_to_jax(params, jnp.float32)})
    got = solver.grad_hv(state)
    worst = 0.0
    for b in meta.layout.epoch_order():
        for first in (True, False):
            G_ref, hv_ref = oracle.grad_and_hv(prob, params, b, first)
            G, hv = got[f"{b.f12}{'W' if first else 'H'}"]
            d = b.d1 if first else b.d2
            G = np.asarray(G, np.float64)[:d]
            for a, r in ((G, G_ref), (np.asarray(hv, np.float64)[:d],
                                      hv_ref(G))):
                worst = max(worst, float(np.max(np.abs(a - r))
                                         / np.max(np.abs(r))))
    return worst


@pytest.mark.parametrize("blocked_bm", [0, 16])
@pytest.mark.parametrize("cfg", GRAD_HV_CONFIGS)
def test_grad_hv_matches_oracle(rng, cfg, blocked_bm):
    """One gradient and one Hv per half-solve, plain COO and blocked
    layouts, at f32 against the fp64 oracle."""
    assert _grad_hv_vs_oracle(rng, cfg, blocked_bm) <= 1e-5


@pytest.mark.gpu
def test_grad_hv_matches_oracle_on_gpu(rng):
    """The same comparison compiled for the card at float32 precision
    (chip_smoke.py phase (b) runs it on every configuration)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU")
    assert _grad_hv_vs_oracle(rng, {}, 16) <= 1e-4


@pytest.mark.parametrize("cfg", [dict(), dict(self_side=False),
                                 dict(cg_precond="jacobi")])
def test_solver_blocked_small_d_fields_match_oracle(rng, monkeypatch, cfg):
    """The XLA blocked path on small non-identity fields (every field of
    the oracle problems: multi-valued rows, D far below the row count) with
    pregather, blocked gap and slot carry on matches the fp64 oracle over
    two epochs."""
    from conftest import make_problem, oracle_params_to_jax, to_device_problem
    from one_class_ffm_tpu.solver import oracle
    from one_class_ffm_tpu.solver.jax_solver import FFMSolver

    monkeypatch.setenv("OCFFM_BLK_PREGATHER", "1")
    prob, params = make_problem(rng, m=24, n=16, Du=(5, 3), Dv=(4, 6),
                                max_nnz=3, **cfg)
    meta, data = to_device_problem(prob, multiple=4, blocked_bm=4)
    assert not any(meta.ident_u) and not any(meta.ident_v)
    solver = FFMSolver(meta, data)
    assert solver.blk_yt and solver.blk_gap
    state = solver.refresh_caches({"params": oracle_params_to_jax(params)})
    ref = params
    for _ in range(2):
        ref = oracle.oracle_epoch(prob, ref)
        state = solver.epoch(state)
    for f12 in ref["W"]:
        for t in ("W", "H"):
            np.testing.assert_allclose(
                np.asarray(state["params"][f12][t]), ref[t][f12],
                rtol=1e-6, atol=1e-9)
