"""Sparse gather/scatter ops, written as plain XLA.

The hot pair (reference UTx/UTX ffm.cpp:314-331 and the X^T z gradient
scatters in gd_*/hs_*):

  project: P[i] = sum_s val[i,s] * W[idx[i,s]]     (padded gather-FMA)
  scatter: G[d] = sum_{i,s: idx[i,s]=d} val[i,s] * Z[i]

On the GPU both are native: an indexed gather and an atomic scatter-add.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp

from .. import platform

Array = jax.Array


def project(idx: Array, val: Array, W: Array) -> Array:
    """P = X W, unrolled over the (small) per-row slot dimension p: per-slot
    (m, k) gathers never materialize an (m, p, k) intermediate."""
    p = idx.shape[1]
    out = val[:, 0, None] * W[idx[:, 0]]
    for s in range(1, p):
        out = out + val[:, s, None] * W[idx[:, s]]
    return out


def segment_sum(data: Array, ids: Array, num: int,
                sorted_ids: bool = False) -> Array:
    """jax.ops.segment_sum accumulated at an f32 floor, returned in f32+:
    a bf16 scatter-add rounds every partial sum to 8 bits, and on the GPU
    it runs as a compare-and-swap loop far slower than f32 atomics
    (PERF.md Findings)."""
    acc = jnp.promote_types(data.dtype, jnp.float32)
    return jax.ops.segment_sum(data.astype(acc), ids, num_segments=num,
                               indices_are_sorted=sorted_ids)


def scatter(idx: Array, val: Array, Z: Array, d: int) -> Array:
    """G = X^T Z via per-slot segment_sum (pads carry val == 0 so they
    contribute zeros), accumulated at an f32 floor."""
    p = idx.shape[1]
    out = segment_sum(val[:, 0, None] * Z, idx[:, 0], d)
    for s in range(1, p):
        out = out + segment_sum(val[:, s, None] * Z, idx[:, s], d)
    return out.astype(Z.dtype)


# ---------------------------------------------------------------------------
# Positive-stream (COO) ops with bounded intermediates
# ---------------------------------------------------------------------------
#
# The gradient/Hv positive passes gather (nnz, k) rows from P/Q and reduce
# them (row-dot or segment-sum).  Materializing the whole gather at once
# costs (nnz, k) device memory (1.28 GB for a (10M, 32) f32 gather).  These
# helpers process the COO stream in fixed chunks so the transient is
# (chunk, k) regardless of nnz.

_NNZ_CHUNK = int(os.environ.get("OCFFM_NNZ_CHUNK", 1 << 21))


def _pad_to(arr: Array, total: int, fill) -> Array:
    return jnp.pad(arr, (0, total - arr.shape[0]), constant_values=fill)


def pos_dot(A: Array, u_ids: Array, B: Array, v_ids: Array,
            max_chunk: int = 0) -> Array:
    """out[t] = <A[u_ids[t]], B[v_ids[t]]> over the COO stream (nnz,)."""
    max_chunk = max_chunk or _NNZ_CHUNK
    nnz = u_ids.shape[0]
    if nnz <= max_chunk:
        return jnp.sum(A[u_ids] * B[v_ids], axis=1)
    n_chunks = -(-nnz // max_chunk)
    total = n_chunks * max_chunk
    up = _pad_to(u_ids, total, 0).reshape(n_chunks, max_chunk)
    vp = _pad_to(v_ids, total, 0).reshape(n_chunks, max_chunk)
    out = jax.lax.map(lambda uv: jnp.sum(A[uv[0]] * B[uv[1]], axis=1), (up, vp))
    return out.reshape(total)[:nnz]


def pos_scatter(w: Array, B: Array, take_ids: Array, seg_ids: Array,
                num_out: int, max_chunk: int = 0,
                seg_sorted: bool = False) -> Array:
    """out[s] += w[t] * B[take_ids[t]] for seg_ids[t] == s: the positive-pass
    scatter (w carries the pad mask, so padded slots contribute zeros; pad
    segment ids == num_out are dropped by segment_sum).

    ``seg_sorted``: the COO stream is u-major sorted, so segment ids by u are
    ascending (ghost/pad ids are the max id, preserving order), which is
    passed on as the ``indices_are_sorted`` hint.  Chunks of a sorted stream
    stay sorted."""
    max_chunk = max_chunk or _NNZ_CHUNK
    nnz = w.shape[0]
    if nnz <= max_chunk:
        return segment_sum(w[:, None] * B[take_ids], seg_ids, num_out,
                           seg_sorted).astype(B.dtype)
    n_chunks = -(-nnz // max_chunk)
    total = n_chunks * max_chunk
    wp = _pad_to(w, total, 0.0).reshape(n_chunks, max_chunk)
    tp = _pad_to(take_ids, total, 0).reshape(n_chunks, max_chunk)
    sp = _pad_to(seg_ids, total, num_out).reshape(n_chunks, max_chunk)

    def body(i, acc):
        return acc + segment_sum(wp[i][:, None] * B[tp[i]], sp[i], num_out,
                                 seg_sorted)

    init = jnp.zeros((num_out, B.shape[1]),
                     jnp.promote_types(B.dtype, jnp.float32))
    return jax.lax.fori_loop(0, n_chunks, body, init).astype(B.dtype)


def pos_scatter_pair(w_a: Array, w_b: Array, B: Array, take_ids: Array,
                     seg_ids: Array, num_out: int, max_chunk: int = 0,
                     seg_sorted: bool = False) -> tuple:
    """Two positive-pass scatters sharing ONE gather of B's rows:

        A[s] += w_a[t] * B[take_ids[t]]          (the gradient's pos term)
        Bq[s] += w_b[t] * B[take_ids[t]]**2      (the Jacobi diag's pos term)

    The random row gather is the expensive half of a positive pass; the two
    payloads are concatenated to (chunk, 2k) and segment-summed in one op,
    so the diagonal preconditioner's cross-block build pays no gather of its
    own (solver._solve_half).
    """
    max_chunk = max_chunk or _NNZ_CHUNK
    nnz = w_a.shape[0]
    k = B.shape[1]

    def one(wa_c, wb_c, t_c, s_c):
        rows = B[t_c]  # ONE gather feeding both payloads
        payload = jnp.concatenate(
            [wa_c[:, None] * rows, wb_c[:, None] * rows * rows], axis=1
        )
        return segment_sum(payload, s_c, num_out, seg_sorted)

    if nnz <= max_chunk:
        out = one(w_a, w_b, take_ids, seg_ids).astype(B.dtype)
        return out[:, :k], out[:, k:]
    n_chunks = -(-nnz // max_chunk)
    total = n_chunks * max_chunk
    wap = _pad_to(w_a, total, 0.0).reshape(n_chunks, max_chunk)
    wbp = _pad_to(w_b, total, 0.0).reshape(n_chunks, max_chunk)
    tp = _pad_to(take_ids, total, 0).reshape(n_chunks, max_chunk)
    sp = _pad_to(seg_ids, total, num_out).reshape(n_chunks, max_chunk)

    def body(i, acc):
        return acc + one(wap[i], wbp[i], tp[i], sp[i])

    init = jnp.zeros((num_out, 2 * k), jnp.promote_types(B.dtype, jnp.float32))
    out = jax.lax.fori_loop(0, n_chunks, body, init).astype(B.dtype)
    return out[:, :k], out[:, k:]


def pos_gram(w: Array, B: Array, take_ids: Array, seg_ids: Array,
             num_out: int, max_chunk: int = 0,
             seg_sorted: bool = False) -> Array:
    """Per-row Gram cache for the CG positive pass:

        M[s] += w[t] * vec( B[take_ids[t]] B[take_ids[t]]^T )   (num_out, k*k)

    With M built once per block solve, the positive Hessian-vector term
    becomes the dense batched matvec ``phi_i @ M_i`` — the per-CG-iteration
    gather+segment pair over the COO stream disappears (the reference pays
    it every iteration, hs_cross ffm.cpp:706-742).  This is the iALS-style
    per-row Gram trick, exact for the same math:

        sum_t w_t <phi_i, B_ot> B_ot  ==  phi_i @ M_i .

    The (k, k) outer products are built directly in flattened (k*k,) form
    via repeat/tile so no (chunk, k, k) intermediate is materialized.

    Chunk size is scaled down by k (intermediates are k x wider than
    pos_scatter's).  w carries the pad mask; pad seg ids == num_out drop.

    Not used by the solver: the build costs several positive passes per
    solve.  Kept as a tested op.
    """
    k = B.shape[1]
    max_chunk = max_chunk or max(1024, _NNZ_CHUNK // max(1, k))
    nnz = w.shape[0]

    def one(w_c, t_c, s_c, acc):
        bc = B[t_c]  # (C, k)
        outer = jnp.repeat(bc, k, axis=1) * jnp.tile(bc, (1, k))  # (C, k*k)
        return acc + segment_sum(w_c[:, None] * outer, s_c, num_out,
                                 seg_sorted).astype(B.dtype)

    init = jnp.zeros((num_out, k * k), B.dtype)
    if nnz <= max_chunk:
        return one(w, take_ids, seg_ids, init)
    n_chunks = -(-nnz // max_chunk)
    total = n_chunks * max_chunk
    wp = _pad_to(w, total, 0.0).reshape(n_chunks, max_chunk)
    tp = _pad_to(take_ids, total, 0).reshape(n_chunks, max_chunk)
    sp = _pad_to(seg_ids, total, num_out).reshape(n_chunks, max_chunk)

    def body(i, acc):
        return one(wp[i], tp[i], sp[i], acc)

    return jax.lax.fori_loop(0, n_chunks, body, init)


def pos_hv(phi: Array, own_ids: Array, B: Array, other_ids: Array,
           w: Array, num_out: int, max_chunk: int = 0) -> Array:
    """Fused positive-pass Hessian-vector term:

        out[s] += w[t] * <phi[own[t]], B[other[t]]> * B[other[t]]  for own[t]==s

    One B-row gather per chunk serves both the row-dot and the scatter — the
    unfused pos_dot + pos_scatter pair gathers B twice.  Binding the gather
    to two consumers makes XLA materialize it, so the solver's plain COO
    path keeps the unfused pair; this form is the plain reference of the
    blocked per-CG-iteration pass (pos_hv_blocked).
    """
    max_chunk = max_chunk or _NNZ_CHUNK
    nnz = w.shape[0]

    def one(own_c, oth_c, w_c, acc):
        bc = B[oth_c]
        pq = jnp.sum(phi[own_c] * bc, axis=1) * w_c
        return acc + segment_sum(pq[:, None] * bc, own_c, num_out)

    acc_t = jnp.promote_types(B.dtype, jnp.float32)
    if nnz <= max_chunk:
        return one(own_ids, other_ids, w,
                   jnp.zeros((num_out, B.shape[1]), acc_t)).astype(B.dtype)
    n_chunks = -(-nnz // max_chunk)
    total = n_chunks * max_chunk
    op = _pad_to(own_ids, total, num_out).reshape(n_chunks, max_chunk)
    tp = _pad_to(other_ids, total, 0).reshape(n_chunks, max_chunk)
    wp = _pad_to(w, total, 0.0).reshape(n_chunks, max_chunk)

    def body(i, acc):
        return one(op[i], tp[i], wp[i], acc)

    init = jnp.zeros((num_out, B.shape[1]), acc_t)
    return jax.lax.fori_loop(0, n_chunks, body, init).astype(B.dtype)


# ---------------------------------------------------------------------------
# Blocked-sorted positive ops: segment reductions as per-block matmuls
# ---------------------------------------------------------------------------
#
# The u-major COO stream is sorted by its segment side, so a window of BM
# consecutive output rows owns a CONTIGUOUS slice of the stream.  Padding
# each window's slice to a common MAXC (once, on the host — the stream is
# static across epochs) turns the whole positive pass into per-block dense
# algebra:
#
#     rows  = B[take_i]                 (MAXC, k)  one random gather
#     ohm   = OneHot(own_local_i)       (MAXC, BM) built on the fly
#     phig  = ohm @ phi_block           gather of phi BY MATMUL
#     out_i = ohm^T @ (coeff * rows)    segment-sum BY MATMUL
#
# replacing XLA's scatter-add with dense per-block matmuls; the remaining
# random access is the shared B-row gather.  Pad entries carry own_local == BM,
# whose one-hot row is all zeros — they vanish from both matmuls with no
# explicit masking.  Accumulation is f32+ regardless of storage dtype
# (strictly better than segment_sum's native-dtype adds).


def make_blocked_layout(seg_ids, take_ids, num_rows: int,
                        block_rows: int = 256, max_pad_ratio: float = 2.0,
                        shard_rows: int = 0, drop=None,
                        head_chunk: int = 512, nch_multiple: int = 8):
    """Host-side (numpy) block-aligned view of the COO stream, segmented by
    ``seg_ids``.  An unsorted segment side is stable-argsorted first — the
    per-call coefficient permutation this induces is a cheap (nnz,) scalar
    gather via ``src`` (unlike the measured-negative v-sorted PAYLOAD copy).

    Returns None when the layout does not apply: num_rows not divisible by
    block_rows, or row skew would pad the stream beyond max_pad_ratio (a
    power-user block sets MAXC for everyone).

    ``drop``: boolean mask of stream entries to EXCLUDE from the layout —
    the zero-weight pads.  They contribute exactly zero to every blocked op
    (coefficients carry the pad mask), but occupying slots inflates MAXC:
    in the shard-aligned layout all of a shard's pads pile into its last
    block.  ``src`` still indexes ORIGINAL stream positions.

    ``shard_rows`` > 0 (requires a SHARD-ALIGNED stream, pad_labels
    shard_rows=...): emit ``src`` SHARD-LOCALLY — relative to the owning
    shard's stream slice of length nnz/S — so the blocked ops can run under
    shard_map with each device gathering coefficients only from its own
    slice.  Requires the stream already sorted by ``seg_ids`` (the aligned
    layout is) and block/shard boundaries to nest (shard_rows % block_rows
    == 0).

    ``head_chunk`` > 0: when a popularity-skewed side would fail the
    pad-ratio guard (a handful of power rows set MAXC for everyone — the
    reference's load-imbalance case, schedule(guided) ffm.cpp:572), split
    TWO-TIER instead of rejecting: the heaviest rows' entries move to a
    chunked HEAD tier ((n_chunks, head_chunk) slots, each chunk owned by
    exactly ONE row, per-row padding < one chunk) and the TAIL tier is the
    ordinary blocked layout over ALL rows with the head entries dropped —
    so its MAXC collapses to the tail's max and every dense per-row term
    still runs once over the full row space.  Extra keys: hd_src/hd_take
    (n_chunks, head_chunk), hd_row/hd_loc (n_chunks,) global row id /
    compact head index per chunk, hd_valid, hd_rows (the (n_head,) sorted
    global head row list), chunk.  ``inv`` then maps into the CONCATENATED
    flat slot space (tail slots first, head slots at offset
    n_blocks * MAXC).  Composes with ``shard_rows`` (round 5): head src
    stays GLOBAL (assembly/carry-propagation only — runtime consumes
    slot-order carried coefficients), the tail keeps shard-local src, and
    ``nch_multiple`` pads the chunk count so the chunk dim can shard
    evenly.  hd_src always indexes ORIGINAL stream positions."""
    import numpy as np

    if block_rows <= 0 or num_rows % block_rows or num_rows == 0:
        return None
    nnz = int(seg_ids.shape[0])
    if nnz == 0:
        return None
    if shard_rows and (shard_rows % block_rows or num_rows % shard_rows
                       or nnz % (num_rows // shard_rows)):
        return None
    seg = np.asarray(seg_ids)
    back = None  # sorted-kept position -> ORIGINAL stream position
    if drop is not None and np.any(drop):
        back = np.nonzero(~np.asarray(drop))[0].astype(np.int64)
        seg = seg[back]
    nnz_k = int(seg.shape[0])
    if nnz_k == 0:
        return None
    needed_sort = bool(np.any(np.diff(seg) < 0))
    if needed_sort:
        order = np.argsort(seg, kind="stable").astype(np.int64)
        seg = seg[order]
        back = order if back is None else back[order]
    n_blocks = num_rows // block_rows

    def block_counts(s):
        starts = np.searchsorted(s, np.arange(0, num_rows + 1, block_rows))
        return starts, np.diff(starts)

    starts, counts = block_counts(seg)
    MAXC = max(8, -(-int(counts.max()) // 8) * 8)
    # cost guard: blocked passes stream n_blocks*MAXC slots; the plain ops
    # they replace stream the whole padded stream (nnz, pads included)
    head_sel = None  # (hd_rows, hd_cnt, hd_first) of the head tier
    if n_blocks * MAXC > max_pad_ratio * nnz:
        if head_chunk <= 0:
            return None
        # two-tier split: over a T ladder, pick the per-row count threshold
        # whose tail layout + chunked head tier stream the FEWEST total
        # slots (n_blocks*MAXC_tail + head slots).  Minimizing head size
        # alone is wrong: it leaves tail MAXC near the power rows' counts —
        # the whole point of the split is a SMALL tail MAXC.
        rowcnt = np.bincount(seg, minlength=num_rows)
        maxcnt = int(rowcnt.max())
        # the head is for POWER rows only: cap it at 1/8 of the nonzero
        # rows (unbounded min-cost degenerates to moving EVERYTHING head-
        # side on small problems), and weight head slots 1.5x in the cost
        # (per-chunk overheads + the scatter over head rows)
        nh_cap = min(1 << 16, max(16, int((rowcnt > 0).sum()) // 8))
        best = None  # (cost, T, maxc_t, head mask)
        T = maxcnt
        while T >= head_chunk:
            T //= 2
            head = rowcnt > T
            n_head = int(head.sum())
            if n_head == 0:
                continue
            if n_head > nh_cap:
                break  # smaller T only grows the head further
            _, bc = block_counts(seg[~head[seg]])
            if bc.size == 0 or bc.max() == 0:
                break  # tail emptied — not a power-row split
            maxc_t = max(8, -(-int(bc.max()) // 8) * 8)
            hd_slots = int(
                (-(-rowcnt[head] // head_chunk) * head_chunk).sum())
            # feasibility: the ACTUAL streamed slots vs the plain ops'
            # stream; selection: head slots weighted 1.5x (chunk overheads
            # + the per-head-row scatter)
            if n_blocks * maxc_t + hd_slots > max_pad_ratio * nnz:
                continue
            cost = n_blocks * maxc_t + 1.5 * hd_slots
            if best is None or cost < best[0]:
                best = (cost, T, maxc_t, head)
        if best is None:
            return None
        _, _, MAXC, head = best
        hd_rows = np.nonzero(head)[0].astype(np.int64)
        head_sel = (hd_rows, rowcnt[hd_rows],
                    np.searchsorted(seg, hd_rows))

    def slots(s, bk, strt, cnts, maxw):
        offs = np.arange(maxw, dtype=np.int64)[None, :]
        pos = strt[:, None] + offs  # positions in seg order
        valid = offs < cnts[:, None]
        pos = np.where(valid, np.minimum(pos, s.shape[0] - 1), 0)
        sr = pos if bk is None else bk[pos]  # ORIGINAL stream positions
        sr = np.where(valid, sr, 0).astype(np.int32)
        tk = np.where(valid, np.asarray(take_ids)[sr], 0).astype(np.int32)
        return sr, tk, pos, valid

    if head_sel is not None:
        hd_rows, hd_cnt, hd_first = head_sel
        hm = np.zeros(num_rows, bool)
        hm[hd_rows] = True
        keep_t = ~hm[seg]
        seg_t = seg[keep_t]
        back_t = (np.nonzero(keep_t)[0] if back is None
                  else back[keep_t]).astype(np.int64)
        starts_t, counts_t = block_counts(seg_t)
    else:
        seg_t, back_t, starts_t, counts_t = seg, back, starts, counts
    src, take, pos, valid = slots(seg_t, back_t, starts_t[:-1], counts_t,
                                  MAXC)
    own_local = np.where(
        valid,
        seg_t[pos]
        - (np.arange(n_blocks, dtype=np.int64) * block_rows)[:, None],
        block_rows,  # pad marker: one-hot row of all zeros
    ).astype(np.int32)
    # inverse map: ORIGINAL stream position -> flat slot index (kept entries
    # only; dropped entries point at slot 0 — their consumers multiply by the
    # zero pad weight, so the value never matters).  Lets per-entry results
    # computed in slot order (e.g. the residual gap) permute back to stream
    # order with one (nnz,) scalar gather.
    offs = np.arange(MAXC, dtype=np.int64)[None, :]
    flat = (np.arange(n_blocks, dtype=np.int64)[:, None] * MAXC
            + offs).astype(np.int32)
    inv = np.zeros(nnz, np.int32)
    inv[src[valid]] = flat[valid]
    out = dict(src=src, own=own_local, take=take, inv=inv,
               block_rows=block_rows, maxc=MAXC)
    if head_sel is not None:
        # head tier: one chunk row owns head_chunk consecutive entries of
        # exactly one head row (entries of a row are contiguous — seg is
        # sorted); per-row padding < one chunk.  Chunk count pads to a
        # multiple of 8 with all-pad chunks (hd_valid False -> zero weight).
        nch_r = (-(-hd_cnt // head_chunk)).astype(np.int64)
        m_nch = max(8, int(nch_multiple))
        NCH = -(-int(nch_r.sum()) // m_nch) * m_nch
        hd_row = np.full(NCH, hd_rows[0], np.int64)
        hd_loc = np.zeros(NCH, np.int64)
        cum = np.cumsum(nch_r) - nch_r
        fill = np.repeat(np.arange(len(hd_rows)), nch_r)
        hd_row[: len(fill)] = hd_rows[fill]
        hd_loc[: len(fill)] = fill
        chunk_in_row = np.arange(len(fill)) - cum[fill]
        cstart = np.zeros(NCH, np.int64)
        cstart[: len(fill)] = hd_first[fill] + chunk_in_row * head_chunk
        cend = np.zeros(NCH, np.int64)
        cend[: len(fill)] = hd_first[fill] + hd_cnt[fill]
        offs_h = np.arange(head_chunk, dtype=np.int64)[None, :]
        pos_h = cstart[:, None] + offs_h
        valid_h = pos_h < cend[:, None]
        pos_h = np.where(valid_h, np.minimum(pos_h, nnz_k - 1), 0)
        src_h = pos_h if back is None else back[pos_h]
        src_h = np.where(valid_h, src_h, 0).astype(np.int32)
        take_h = np.where(valid_h,
                          np.asarray(take_ids)[src_h], 0).astype(np.int32)
        flat_h = (n_blocks * MAXC
                  + np.arange(NCH, dtype=np.int64)[:, None] * head_chunk
                  + offs_h).astype(np.int32)
        inv[src_h[valid_h]] = flat_h[valid_h]
        out.update(hd_src=src_h, hd_take=take_h,
                   hd_row=hd_row.astype(np.int32),
                   hd_loc=hd_loc.astype(np.int32), hd_valid=valid_h,
                   hd_rows=hd_rows.astype(np.int64), chunk=head_chunk)
    if shard_rows:
        if needed_sort:
            return None  # shard-local src needs the seg-sorted stream
        L = nnz // (num_rows // shard_rows)
        lo = (np.arange(n_blocks, dtype=np.int64)
              // (shard_rows // block_rows) * L)[:, None].astype(np.int32)
        if not (np.all(src[valid] >= np.broadcast_to(lo, src.shape)[valid])
                and np.all(src[valid]
                           < np.broadcast_to(lo + L, src.shape)[valid])):
            raise ValueError(
                "stream is not shard-aligned: a block's entries cross its "
                "shard's stream slice (build labels with pad_labels "
                "shard_rows=...)")
        out["src_abs"] = src
        out["src"] = np.where(valid, src - lo, 0).astype(np.int32)
    return out


def _up(a, acc_t):
    """CPU-only upcast for bf16 dot operands: the CPU dot thunk cannot
    execute BF16 x BF16 = F32, and casting bf16 inputs to f32 before an
    f32-accumulating dot gives the same result (bf16 products are exact in
    f32).  No-op on the GPU, whose bf16 dots take the operands as they are."""
    if a.dtype == jnp.bfloat16 and platform.backend() == "cpu":
        return a.astype(acc_t)
    return a


def _blocked_dot(a: Array, b: Array, out_dtype):
    acc = jnp.promote_types(out_dtype, jnp.float32)
    return jax.lax.dot(_up(a, acc), _up(b, acc),
                       preferred_element_type=acc).astype(out_dtype)


# One big up-front row gather per GROUP of blocks instead of one small
# gather per block: per-block gathers in a fori_loop are latency-bound.  The
# prefetch transient is (G, MAXC, k) — bounded by OCFFM_BLK_PREFETCH bytes.
_BLK_PREFETCH = int(os.environ.get("OCFFM_BLK_PREFETCH", 1 << 29))


def gather_blocked_rows(B: Array, take: Array) -> Array:
    """Materialize the blocked stream's B rows ONCE: (n_blocks, MAXC, k).

    B is loop-invariant across a block solve (only phi changes per CG
    iteration), so the random row gather can be paid once per solve; the
    gradient pass and every CG iteration then stream the result
    sequentially."""
    n_blocks, MAXC = take.shape
    return B[take.reshape(-1)].reshape(n_blocks, MAXC, B.shape[1])


def _blk_group(n_blocks: int, maxc: int, k: int, itemsize: int) -> int:
    per_block = max(1, maxc * k * itemsize)
    return max(1, min(n_blocks, _BLK_PREFETCH // per_block))


def pos_scatter_blocked(coeff: Array, B: Array, take: Array, src: Array,
                        own: Array, num_out: int, block_rows: int,
                        diag_w: Array | None = None,
                        rows: Array | None = None,
                        diag_w_blk: Array | None = None,
                        coeff_blk: Array | None = None):
    """Blocked-sorted pos_scatter: out[s] += coeff[t] * B[take[t]].

    ``coeff`` is in ORIGINAL stream order (gathered per block via ``src``).
    ``coeff_blk``: the coefficients already in (n_blocks, MAXC) slot order
    (the solver's slot-order residual mode) — read by dynamic_slice, no
    scalar gather at all.  Overrides ``coeff``/``src`` (both may be None).
    With ``diag_w``: also return the Jacobi diag positive term
    sum diag_w[t] * B[take[t]]^2 from the same B gather (the fused
    grad+diag pair, cf. pos_scatter_pair).
    ``diag_w_blk``: the diag weights in PRE-PERMUTED (n_blocks, MAXC) form —
    they are STATIC ((1-w) * the pad mask), so the per-solve random scalar
    gather diag_w[src] can be paid once at data-assembly time (the w_blk
    trick; bit-equal since the same float pairs multiply).  Overrides
    ``diag_w``.
    With ``rows`` (gather_blocked_rows output): skip the random gather and
    stream the pre-gathered (n_blocks, MAXC, k) array sequentially (``B``
    and ``take`` may then be None — e.g. under shard_map where only the
    pre-gathered local stream exists)."""
    n_blocks, MAXC = own.shape
    k = rows.shape[2] if rows is not None else B.shape[1]
    dt = rows.dtype if rows is not None else B.dtype
    with_diag = diag_w is not None or diag_w_blk is not None
    G = _blk_group(n_blocks, MAXC, k, jnp.dtype(dt).itemsize)
    n_groups = -(-n_blocks // G)
    iota = jax.lax.broadcasted_iota(jnp.int32, (MAXC, block_rows), 1)

    def outer(g, carry):
        # overlapping last group recomputes a few blocks — idempotent
        # (each block's output rows depend only on its own entries)
        base = jnp.minimum(g * G, n_blocks - G)
        src_g = None if src is None else jax.lax.dynamic_slice(
            src, (base, 0), (G, MAXC))
        own_g = jax.lax.dynamic_slice(own, (base, 0), (G, MAXC))
        if rows is not None:
            rows_g = jax.lax.dynamic_slice(rows, (base, 0, 0), (G, MAXC, k))
        else:
            take_g = jax.lax.dynamic_slice(take, (base, 0), (G, MAXC))
            rows_g = B[take_g.reshape(-1)].reshape(G, MAXC, k)
        if coeff_blk is not None:
            cb_g = jax.lax.dynamic_slice(coeff_blk, (base, 0), (G, MAXC))
        else:
            cb_g = coeff[src_g]
        if diag_w_blk is not None:
            wq_g = jax.lax.dynamic_slice(diag_w_blk, (base, 0), (G, MAXC))
        elif diag_w is not None:
            wq_g = diag_w[src_g]
        else:
            wq_g = None

        def inner(j, carry):
            out, outq = carry
            rows = rows_g[j]
            ohm = (own_g[j][:, None] == iota).astype(dt)  # (MAXC, BM)
            blockv = _blocked_dot(ohm.T, cb_g[j][:, None] * rows, dt)
            row0 = (base + j) * block_rows
            out = jax.lax.dynamic_update_slice(out, blockv, (row0, 0))
            if with_diag:
                bq = _blocked_dot(
                    ohm.T, wq_g[j][:, None] * rows * rows, dt)
                outq = jax.lax.dynamic_update_slice(outq, bq, (row0, 0))
            return out, outq

        return jax.lax.fori_loop(0, G, inner, carry)

    init = (jnp.zeros((num_out, k), dt),
            jnp.zeros((num_out, k), dt) if with_diag
            else jnp.zeros((), dt))
    out, outq = jax.lax.fori_loop(0, n_groups, outer, init)
    if with_diag:
        return out, outq
    return out


def pos_gap_blocked(dT: Array, rows: Array, own: Array, inv: Array | None,
                    block_rows: int) -> Array:
    """Blocked-sorted residual gap: gap[t] = <dT[own_t], B[take_t]> for every
    ORIGINAL stream entry (the update_side/update_cross "gaps" pass, ref
    ffm.cpp:405-465).

    The plain pos_dot form pays two random row gathers over the whole
    positive stream — dT by the (sorted) own side and B by the other side —
    once per table solve.  With the solve's pre-gathered stream available
    (``rows`` = gather_blocked_rows output: B is unchanged by the step being
    applied, W/H and the own-side cache are what moved), both gathers
    disappear: the own side becomes the one-hot gather-by-matmul and the
    B side streams sequentially.  Only an (nnz,) SCALAR gather (``inv``, the
    layout's static original->slot map) permutes the result back to stream
    order; entries outside the layout land on slot 0 and are killed by the
    caller's pad-weight multiply.  Pad slots have an all-zero one-hot row, so
    their gap is exactly 0.

    ``inv`` None: return the FLAT (n_blocks * MAXC,) slot-order result with
    no permute at all — for callers that carry the residual itself in slot
    order (the solver's OCFFM_BLK_YT mode)."""
    n_blocks, MAXC = own.shape
    k = rows.shape[2]
    dt = rows.dtype
    G = _blk_group(n_blocks, MAXC, k, jnp.dtype(dt).itemsize)
    n_groups = -(-n_blocks // G)
    iota = jax.lax.broadcasted_iota(jnp.int32, (MAXC, block_rows), 1)

    def outer(g, flat):
        # overlapping last group recomputes a few blocks — idempotent (each
        # flat slot is rewritten with the same value)
        base = jnp.minimum(g * G, n_blocks - G)
        own_g = jax.lax.dynamic_slice(own, (base, 0), (G, MAXC))
        rows_g = jax.lax.dynamic_slice(rows, (base, 0, 0), (G, MAXC, k))

        def inner(j, flat):
            ohm = (own_g[j][:, None] == iota).astype(dt)  # (MAXC, BM)
            row0 = (base + j) * block_rows
            dTb = jax.lax.dynamic_slice(dT, (row0, 0), (block_rows, k))
            phig = _blocked_dot(ohm, dTb, dt)             # (MAXC, k)
            gap = jnp.sum(phig * rows_g[j], axis=1)       # (MAXC,)
            return jax.lax.dynamic_update_slice(
                flat, gap, ((base + j) * MAXC,))

        return jax.lax.fori_loop(0, G, inner, flat)

    flat = jax.lax.fori_loop(0, n_groups, outer,
                             jnp.zeros(n_blocks * MAXC, dt))
    return flat if inv is None else flat[inv]


def seg_sum_blocked(c_blk: Array, own: Array, num_rows: int,
                    block_rows: int) -> Array:
    """Per-row sums of slot-order per-entry values: out[s] = sum over the
    slots whose entry belongs to row s (segment_sum as per-block one-hot
    matvecs — sequential streaming, no random access; the blocked form of
    gd_side's per-positive sum, ref ffm.cpp:537-592).

    ``c_blk``: (n_blocks, MAXC) values in slot order.  Pad slots have an
    all-zero one-hot row, so they contribute exactly 0 whatever they hold."""
    n_blocks, MAXC = own.shape
    dt = c_blk.dtype
    G = _blk_group(n_blocks, MAXC, 1, jnp.dtype(dt).itemsize)
    n_groups = -(-n_blocks // G)
    iota = jax.lax.broadcasted_iota(jnp.int32, (MAXC, block_rows), 1)

    def outer(g, out):
        base = jnp.minimum(g * G, n_blocks - G)
        own_g = jax.lax.dynamic_slice(own, (base, 0), (G, MAXC))
        c_g = jax.lax.dynamic_slice(c_blk, (base, 0), (G, MAXC))

        def inner(j, out):
            ohm = (own_g[j][:, None] == iota).astype(dt)   # (MAXC, BM)
            blockv = _blocked_dot(ohm.T, c_g[j][:, None], dt)[:, 0]
            return jax.lax.dynamic_update_slice(
                out, blockv, ((base + j) * block_rows,))

        return jax.lax.fori_loop(0, G, inner, out)

    return jax.lax.fori_loop(0, n_groups, outer, jnp.zeros(num_rows, dt))


def expand_rows_blocked(vec: Array, own: Array, block_rows: int) -> Array:
    """Per-slot copy of a per-row vector, in slot order: out flat slot t =
    vec[row owning t] (the gather vec[seg_ids] as per-block one-hot matvecs
    — ``vec`` is read sequentially, no random access).  Pad slots get
    exactly 0 (all-zero one-hot row)."""
    n_blocks, MAXC = own.shape
    dt = vec.dtype
    G = _blk_group(n_blocks, MAXC, 1, jnp.dtype(dt).itemsize)
    n_groups = -(-n_blocks // G)
    iota = jax.lax.broadcasted_iota(jnp.int32, (MAXC, block_rows), 1)

    def outer(g, flat):
        base = jnp.minimum(g * G, n_blocks - G)
        own_g = jax.lax.dynamic_slice(own, (base, 0), (G, MAXC))

        def inner(j, flat):
            ohm = (own_g[j][:, None] == iota).astype(dt)   # (MAXC, BM)
            row0 = (base + j) * block_rows
            vb = jax.lax.dynamic_slice(vec, (row0,), (block_rows,))
            slot = _blocked_dot(ohm, vb[:, None], dt)[:, 0]  # (MAXC,)
            return jax.lax.dynamic_update_slice(
                flat, slot, ((base + j) * MAXC,))

        return jax.lax.fori_loop(0, G, inner, flat)

    return jax.lax.fori_loop(0, n_groups, outer,
                             jnp.zeros(n_blocks * MAXC, dt))


# ---------------------------------------------------------------------------
# Head-tier ops (the two-tier skew layout's chunked dense path)
# ---------------------------------------------------------------------------
#
# Every positive pass is LINEAR over stream entries, so the two-tier split is
# exact: the tail tier runs the ordinary blocked ops (with head entries
# dropped) and these ops add the head entries' contributions.  A head chunk
# owns head_chunk consecutive entries of exactly ONE power row, so the
# per-row segment structure degenerates to dense per-chunk reductions
# (batched matvecs) followed by a scatter-add over the FEW chunks — the
# O(num_rows) scatter that motivated the blocked layout never reappears.
# The per-row dense terms (omega Grams, the Jacobi omega diag) are NOT
# duplicated here: the tail layout still spans the full row space, so its
# passes carry them for head rows too.  Reference analog: the load-balanced
# hot loops (schedule(guided), ffm.cpp:572) — here a power row becomes a
# dense chunked stream.  The head stream is row-major, (NCH, CHUNK, k), as
# gather_blocked_rows returns it.


def head_chunk_sums(c_hd: Array, rows_hd: Array) -> Array:
    """Per-chunk weighted row sums: out[c] = sum_t c_hd[c,t] * rows_hd[c,t]
    — (NCH, CHUNK) x (NCH, CHUNK, k) -> (NCH, k), f32+ accumulation."""
    acc_t = jnp.promote_types(rows_hd.dtype, jnp.float32)
    z = jnp.einsum("nc,nck->nk", _up(c_hd, acc_t), _up(rows_hd, acc_t),
                   preferred_element_type=acc_t)
    return z.astype(rows_hd.dtype)


def head_pq(phig: Array, rows_hd: Array) -> Array:
    """Per-entry inner products <phig[c], rows_hd[c,t]> -> (NCH, CHUNK):
    the head form of the positive pass's phi-row dot (pad entries are
    masked by the caller's weight multiply)."""
    acc_t = jnp.promote_types(rows_hd.dtype, jnp.float32)
    pq = jnp.einsum("nk,nck->nc", _up(phig, acc_t), _up(rows_hd, acc_t),
                    preferred_element_type=acc_t)
    return pq.astype(rows_hd.dtype)


def head_seg_sum(c_hd: Array, hd_row: Array, num_rows: int) -> Array:
    """Per-row sums of head slot values: (NCH, CHUNK) -> (num_rows,) via
    chunk reductions + an (NCH,)-row scatter-add (pad slots carry weight 0,
    pad chunks scatter zeros)."""
    acc_t = jnp.promote_types(c_hd.dtype, jnp.float32)
    s = jnp.sum(c_hd.astype(acc_t), axis=1)
    return segment_sum(s, hd_row, num_rows).astype(c_hd.dtype)


def head_scatter(c_hd: Array, rows_hd: Array, hd_row: Array, num_out: int,
                 diag_w_hd: Array | None = None):
    """Head form of pos_scatter_blocked: out[r] += sum over r's head
    entries of c * B_row (plus the Jacobi diag's squared-row payload when
    ``diag_w_hd`` is given)."""
    dt = rows_hd.dtype
    z = head_chunk_sums(c_hd, rows_hd)
    out = segment_sum(z, hd_row, num_out).astype(dt)
    if diag_w_hd is None:
        return out
    q = head_chunk_sums(diag_w_hd, rows_hd * rows_hd)
    return out, segment_sum(q, hd_row, num_out).astype(dt)


def head_hv(phi: Array, rows_hd: Array, w_hd: Array, hd_row: Array,
            num_out: int, w_scale: float = 1.0) -> Array:
    """Head form of the per-CG-iteration positive pass: zp[r] += sum over
    r's head entries of w <phi_r, B_t> B_t.  The dense omega term is NOT
    added (the tail pass covers all rows)."""
    dt = rows_hd.dtype
    phig = phi[hd_row]
    c = head_pq(phig, rows_hd) * (w_hd * jnp.asarray(w_scale, dt))
    z = head_chunk_sums(c, rows_hd)
    return segment_sum(z, hd_row, num_out).astype(dt)


def pos_hv_blocked(phi: Array, B: Array, w: Array, take: Array, src: Array,
                   own: Array, num_out: int, block_rows: int,
                   rows: Array | None = None,
                   w_blk: Array | None = None, w_scale: float = 1.0,
                   dense_mat: Array | None = None) -> Array:
    """Blocked-sorted fused CG positive term (pos_dot + pos_scatter in one
    B gather):  zp[s] += w[t] * <phi[u_t], B[take_t]> * B[take_t].

    ``rows`` (gather_blocked_rows output): B is constant across a solve's CG
    iterations — pass the pre-gathered stream and every iteration reads it
    sequentially instead of paying the random gather again.
    ``w_blk``: the weights in PRE-PERMUTED (n_blocks, MAXC) form (built once
    at data-assembly time — pos_w is static), scaled by ``w_scale``; skips
    the per-iteration random scalar gather w[src].  (w_scale * w)[src] ==
    (w[src]) * w_scale exactly, so this path is bit-equal.
    ``dense_mat``: optional (k, k) matrix; adds phi_block @ dense_mat to each
    output block — fuses the CG omega term phi @ (omega Q1^T Q1) into the
    same pass (accumulated in f32 with the positive term, then cast once).
    With both ``rows`` and ``w_blk``, ``B``/``w``/``take``/``src`` may be
    None (the shard_map-local form)."""
    n_blocks, MAXC = own.shape
    k = rows.shape[2] if rows is not None else B.shape[1]
    dt = rows.dtype if rows is not None else B.dtype
    G = _blk_group(n_blocks, MAXC, k, jnp.dtype(dt).itemsize)
    n_groups = -(-n_blocks // G)
    iota = jax.lax.broadcasted_iota(jnp.int32, (MAXC, block_rows), 1)
    acc_t = jnp.promote_types(dt, jnp.float32)

    def outer(g, out):
        base = jnp.minimum(g * G, n_blocks - G)
        own_g = jax.lax.dynamic_slice(own, (base, 0), (G, MAXC))
        if rows is not None:
            rows_g = jax.lax.dynamic_slice(rows, (base, 0, 0), (G, MAXC, k))
        else:
            take_g = jax.lax.dynamic_slice(take, (base, 0), (G, MAXC))
            rows_g = B[take_g.reshape(-1)].reshape(G, MAXC, k)
        if w_blk is not None:
            wb_g = jax.lax.dynamic_slice(
                w_blk, (base, 0), (G, MAXC)) * jnp.asarray(w_scale, dt)
        else:
            src_g = jax.lax.dynamic_slice(src, (base, 0), (G, MAXC))
            wb_g = w[src_g]

        def inner(j, out):
            rows = rows_g[j]
            ohm = (own_g[j][:, None] == iota).astype(dt)
            row0 = (base + j) * block_rows
            phib = jax.lax.dynamic_slice(phi, (row0, 0), (block_rows, k))
            phig = _blocked_dot(ohm, phib, dt)
            pq = jnp.sum(phig * rows, axis=1) * wb_g[j]
            blockv = jax.lax.dot(_up(ohm.T, acc_t),
                                 _up(pq[:, None] * rows, acc_t),
                                 preferred_element_type=acc_t)
            if dense_mat is not None:
                blockv = blockv + jax.lax.dot(
                    _up(phib, acc_t), _up(dense_mat, acc_t),
                    preferred_element_type=acc_t)
            return jax.lax.dynamic_update_slice(
                out, blockv.astype(dt), (row0, 0))

        return jax.lax.fori_loop(0, G, inner, out)

    return jax.lax.fori_loop(0, n_groups, outer,
                             jnp.zeros((num_out, k), dt))
