"""Two-tier (head/tail) blocked layout for popularity skew.

A zipf-style catalog has a handful of power rows whose positive counts set
MAXC for every block — round 3 rejected the whole blocked layout past a 2x
pad ratio and fell back to plain COO ops, losing the blocked path exactly on
the realistic (skewed) datasets.  The two-tier split keeps the tail on the
blocked ops (head entries dropped, so MAXC collapses) and
streams the head rows' entries through dense chunked ops
(ops.head_* — see ops.make_blocked_layout ``head_chunk``).

Reference analog: the OpenMP hot loops' load balancing
(schedule(guided), ffm.cpp:572) — here solved by layout, not scheduling.
"""

import numpy as np
import pytest

from conftest import make_problem, oracle_params_to_jax, to_device_problem


def _skewed_problem(rng, m=40, n=24, density=0.3, u_head=False):
    """Tiny problem with power rows: every user likes item 0 (v-side head);
    optionally user 0 likes every item (u-side head)."""
    prob, params = make_problem(rng, m=m, n=n, self_side=True,
                                density=density)
    pos = np.asarray(prob.pos).copy()
    pos[:, 0] = True
    if u_head:
        pos[0, :] = True
    prob.pos = pos
    return prob, params


def test_two_tier_layout_invariants(rng):
    """Construction: tail + head slots partition the kept entries exactly,
    own/take/hd_row agree with the stream, and ``inv`` round-trips through
    the concatenated flat slot space."""
    from one_class_ffm_tpu.ops.sparse_ops import make_blocked_layout

    num_rows, BM, CH = 24, 4, 8
    cnt = rng.integers(1, 5, size=num_rows)
    cnt[0], cnt[7] = 40, 25
    seg = np.repeat(np.arange(num_rows), cnt)
    nnz = seg.size
    take = rng.integers(0, 100, size=nnz)
    perm = rng.permutation(nnz)  # force the sort path (the v side's case)
    drop = np.zeros(nnz, bool)
    drop[rng.choice(nnz, 5, replace=False)] = True

    for seg_in, take_in in ((seg, take), (seg[perm], take[perm])):
        out = make_blocked_layout(seg_in, take_in, num_rows, BM,
                                  max_pad_ratio=2.0, drop=drop,
                                  head_chunk=CH)
        assert out is not None and "hd_row" in out
        kept = np.nonzero(~drop)[0]
        ok = out["own"] < BM
        tail_pos = out["src"][ok]
        hd_pos = out["hd_src"][out["hd_valid"]]
        assert np.array_equal(
            np.sort(np.concatenate([tail_pos, hd_pos])), np.sort(kept))
        nb = num_rows // BM
        blkrow = np.arange(nb)[:, None] * BM + out["own"]
        assert np.array_equal(seg_in[tail_pos], blkrow[ok])
        assert np.array_equal(
            seg_in[hd_pos],
            np.broadcast_to(out["hd_row"][:, None],
                            out["hd_src"].shape)[out["hd_valid"]])
        assert np.array_equal(out["take"][ok], take_in[tail_pos])
        assert np.array_equal(out["hd_take"][out["hd_valid"]],
                              take_in[hd_pos])
        assert np.array_equal(out["hd_rows"][out["hd_loc"]], out["hd_row"])
        # inv round trip through the concat flat space
        MAXC = out["maxc"]
        NCH = out["hd_src"].shape[0]
        vals = rng.normal(size=nnz)
        flat = np.zeros(nb * MAXC + NCH * CH)
        tflat = np.arange(nb)[:, None] * MAXC + np.arange(MAXC)[None, :]
        flat[tflat[ok]] = vals[tail_pos]
        hflat = (nb * MAXC + np.arange(NCH)[:, None] * CH
                 + np.arange(CH)[None, :])
        flat[hflat[out["hd_valid"]]] = vals[hd_pos]
        assert np.allclose(flat[out["inv"]][kept], vals[kept])

    # rejected outright when two-tier is disabled (the round-3 behavior)
    assert make_blocked_layout(seg, take, num_rows, BM, max_pad_ratio=2.0,
                               drop=drop, head_chunk=0) is None


@pytest.mark.parametrize("yt", ["0", "auto"])  # OCFFM_BLK_YT: carry off/on
@pytest.mark.parametrize("both_sides", [False, True])
def test_two_tier_epoch_matches_plain(rng, monkeypatch, yt, both_sides):
    """Two epochs on the two-tier layout == the plain solver to 1e-6, with
    the head tier asserted ON (v side always; both sides in the dense-skew
    variant), with and without the slot-order carry."""
    from one_class_ffm_tpu.solver.jax_solver import FFMSolver

    monkeypatch.setenv("OCFFM_HEAD_CHUNK", "8")
    monkeypatch.setenv("OCFFM_BLK_YT", yt)
    prob, params = _skewed_problem(
        rng, density=0.08 if both_sides else 0.3, u_head=both_sides)

    meta_p, data_p = to_device_problem(prob, row_pad=1, multiple=8)
    plain = FFMSolver(meta_p, data_p)
    st = plain.refresh_caches({"params": oracle_params_to_jax(params)})
    ref = plain.epoch(plain.epoch(st))

    meta_b, data_b = to_device_problem(prob, row_pad=1, multiple=8,
                                       blocked_bm=4)
    solver = FFMSolver(meta_b, data_b)
    assert solver.hd_v  # the power item engaged the head tier
    if both_sides:
        assert solver.hd_u
    if yt == "auto":
        # the tail MAXC collapse keeps the whole blocked stack on
        assert solver.blk_yt and solver.pregather_u and solver.pregather_v
    st2 = solver.refresh_caches({"params": oracle_params_to_jax(params)})
    got = solver.epoch(solver.epoch(st2))
    for f12, blk in ref["params"].items():
        for key in ("W", "H"):
            np.testing.assert_allclose(
                np.asarray(got["params"][f12][key]), np.asarray(blk[key]),
                rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(
        np.asarray(solver.yt_stream(got)), np.asarray(plain.yt_stream(ref)),
        rtol=1e-6, atol=1e-9)


def test_two_tier_objective_and_refresh(rng, monkeypatch):
    """The exact objective (oracle cross-check) and a refresh_caches round
    trip agree between the two-tier and plain solvers."""
    from one_class_ffm_tpu.solver.jax_solver import FFMSolver

    monkeypatch.setenv("OCFFM_HEAD_CHUNK", "8")
    prob, params = _skewed_problem(rng)
    meta_p, data_p = to_device_problem(prob, row_pad=1, multiple=8)
    meta_b, data_b = to_device_problem(prob, row_pad=1, multiple=8,
                                       blocked_bm=4)
    plain = FFMSolver(meta_p, data_p)
    solver = FFMSolver(meta_b, data_b)
    assert solver.hd_v and solver.blk_yt
    jp = oracle_params_to_jax(params)
    st_p = plain.refresh_caches({"params": jp})
    st_b = solver.refresh_caches({"params": jp})
    np.testing.assert_allclose(float(plain.objective(st_p)),
                               float(solver.objective(st_b)), rtol=1e-10)
    st_b2 = solver.epoch(st_b)
    st_p2 = plain.epoch(st_p)
    np.testing.assert_allclose(float(plain.objective(st_p2)),
                               float(solver.objective(st_b2)), rtol=1e-8)
    # refresh from the advanced params reproduces the carried residual
    re = solver.refresh_caches({"params": st_b2["params"]})
    np.testing.assert_allclose(np.asarray(re["yt_v_hd"]),
                               np.asarray(st_b2["yt_v_hd"]),
                               rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("both_sides", [False, True])
def test_two_tier_epoch_matches_plain_under_mesh(rng, monkeypatch,
                                                 both_sides):
    """A popularity-skewed problem on the 8-device CPU mesh runs the
    two-tier head split WITH the sharded blocked passes (carry mode,
    shard_map-local tail passes; head ops at jit level, GSPMD-partitioned)
    and matches the plain single-device epoch to 1e-6 — skew does not knock
    the mesh back to the sharded fallback."""
    import jax

    from one_class_ffm_tpu.parallel import make_mesh, shard_data, shard_state
    from one_class_ffm_tpu.solver.jax_solver import FFMSolver

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    monkeypatch.setenv("OCFFM_HEAD_CHUNK", "8")
    S, BM = 8, 4
    # larger than the single-shard cases: the shard-aligned stream's pads
    # raise the layout's pad-ratio denominator, so the skew must be
    # concentrated enough to trip the two-tier split through them
    prob, params = _skewed_problem(
        rng, m=160, n=64 if both_sides else 24,
        density=0.03 if both_sides else 0.05, u_head=both_sides)
    meta_p, data_p = to_device_problem(prob, row_pad=1, multiple=S * BM)
    plain = FFMSolver(meta_p, data_p)
    st = plain.refresh_caches({"params": oracle_params_to_jax(params)})
    ref = plain.epoch(plain.epoch(st))

    mesh = make_mesh(S)
    meta_b, data_b = to_device_problem(
        prob, row_pad=1, multiple=S * BM, blocked_bm=BM, blocked_shards=S)
    sdata = shard_data(data_b, mesh)
    ssolver = FFMSolver(meta_b, sdata, mesh=mesh)
    assert ssolver.hd_v  # the power item engaged the head tier
    if both_sides:
        assert ssolver.hd_u
    # carry mode with the head tier ON — not the sharded fallback
    assert ssolver.blk_yt and ssolver.blk_v_on
    sstate = shard_state(
        ssolver.refresh_caches({"params": oracle_params_to_jax(params)}),
        mesh)
    got = ssolver.epoch(ssolver.epoch(sstate))
    for f12, blk in ref["params"].items():
        for key in ("W", "H"):
            np.testing.assert_allclose(
                np.asarray(got["params"][f12][key]), np.asarray(blk[key]),
                rtol=1e-6, atol=1e-9)
