"""Alternating Gauss-Newton solver for one-class FFM, in JAX.

This is the JAX re-design of the reference solver core (ImpProblem,
reference ffm.cpp:314-870).  Same math, different architecture:

  * the C++ stores residuals inside mutable label nodes and updates them in
    place (ffm.cpp:388-403, 405-465); here the residual vector ``yt`` over the
    flat COO positive stream is *carried functionally* through the epoch and
    updated with pure array ops.  (Under OCFFM_BLK_YT the carry lives in the
    blocked SLOT orders — ``yt_u``/``yt_v`` — so the hot passes touch it
    only elementwise/sequentially; same floats, permuted positions.)
  * OpenMP parallel-for over rows (ffm.cpp:328,572,...) becomes batched
    matmul / segment_sum primitives that XLA compiles for the device and GSPMD
    can shard over a device mesh (rows on the ``data`` axis).
  * the two adjacency copies (U->V and V->U, transY ffm.cpp:259-294) are
    replaced by a single COO stream segment-summed by either endpoint.
  * per-block conjugate gradient (ffm.cpp:744-813) is a ``lax.while_loop``
    with the reference's exact stopping rule (||r||^2 <= 0.09 ||g||^2, cap 20).

The omega-weighted full m x n negative term is never materialized: per-row
sums use ``n (a_i - r) + sum(b) + sa_i`` and k x k Grams Q_c^T Q1 exactly as
the reference does (cache_sasb ffm.cpp:514-535, gd_cross ffm.cpp:658-670).

Everything in this file is functionally pure and jittable end-to-end; one
epoch is one XLA computation.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import platform
from ..data.dataset import PaddedFields, PaddedLabels
from ..models.blocks import BlockInfo, BlockLayout
from .params import HyperParams

Array = jax.Array


# ---------------------------------------------------------------------------
# Device-side problem container
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ProblemMeta:
    """Static (hashable) problem description closed over by jitted fns."""

    layout: BlockLayout
    hp: HyperParams
    m: int  # padded user rows
    n: int  # padded item rows
    m_true: int
    n_true: int
    nnz: int  # padded positive count
    dtype: Any = jnp.float32
    d_multiple: int = 1  # block-table row dims rounded up to this multiple
    # per-field "strict identity encoding" flags (p=1, val=1, idx[i]=i,
    # D == rows): project == zero-padded table, scatter == masked slice —
    # no random access at all.  Detected from the data in make_device_data.
    ident_u: Tuple[bool, ...] = ()
    ident_v: Tuple[bool, ...] = ()
    # > 0: the COO stream has a block-aligned layout in data
    # (blk_u_*/blk_v_*) and that side's cross positive passes run as
    # per-block one-hot matmuls instead of segment scatter-adds
    # (ops.pos_hv_blocked / pos_scatter_blocked).  Value = rows per block.
    blocked_bm_u: int = 0
    blocked_bm_v: int = 0
    # > 1: the stream is SHARD-ALIGNED over this many data-mesh shards
    # (pad_labels shard_rows=...) and the u-side blocked layout carries
    # shard-LOCAL src indices — the blocked positive passes then run under
    # shard_map, each device streaming only its own slice (the solver must
    # be constructed with the mesh).  The v-side layout is built too (slot
    # arrays shard on the blocks dim; its global src is assembly-time
    # only): with BOTH layouts the slot-order residual carry engages and
    # both sides' blocked passes run shard-locally.
    blocked_shards: int = 1

    def pad_d(self, d: int) -> int:
        """Padded table row dim.  Pad rows are never indexed by any feature,
        are zero at init and receive zero gradient/Hv contributions, so they
        stay exactly zero — the same invariant as row padding.  This is what
        makes model-axis (tensor-parallel) row-sharding of tables possible
        for arbitrary field dims (mesh-size divisibility by construction)."""
        mult = max(1, self.d_multiple)
        return -(-d // mult) * mult


def make_device_data(
    u: PaddedFields,
    v: PaddedFields,
    y: PaddedLabels,
    layout: BlockLayout,
    hp: HyperParams,
    dtype=jnp.float32,
    d_multiple: int = 1,
    blocked_bm: int = 0,
    blocked_shards: int = 1,
) -> Tuple[ProblemMeta, Dict[str, Any]]:
    """Assemble the device array dict + static meta from host padded views.

    ``data`` layout (all jnp arrays):
      xu_idx/xu_val: per user field (m, p_f)
      xv_idx/xv_val: per item field (n, p_f)
      pos_u/pos_v:   (nnz,) COO positive endpoints (ghost rows for pads)
      pos_w:         (nnz,) 1.0 real / 0.0 pad mask
      cnt_u/cnt_v:   per-row positive counts |Omega+_i|
      reg_u/reg_v:   per field (D_f,) lambda row weights (freq or ones)

    ``d_multiple`` > 1 rounds every block table's row dim (and its reg
    vector) up to that multiple so tables divide a ``model`` mesh axis.

    ``blocked_bm`` > 0 additionally builds block-aligned views of the
    positive stream for BOTH segment sides (blk_u_*/blk_v_* arrays; see
    ops.make_blocked_layout) where they apply (row count divisible, skew
    within budget).

    ``blocked_shards`` S > 1: the labels were built SHARD-ALIGNED
    (pad_labels shard_rows = u.m/S) and the u-side blocked layout is
    emitted with shard-local src, so its positive passes run under
    shard_map on an S-way data mesh (construct FFMSolver with mesh=...).
    The v side keeps the plain COO ops (an item's positives span user
    shards, so no local layout exists for it).
    """
    def ident_flags(pf: PaddedFields) -> Tuple[bool, ...]:
        """Strict identity-encoded fields: row i's single feature is
        (idx=i, val=1) and the field dim equals the true row count.  For
        such fields X is the identity (plus zero pad rows), so X W == W
        and X^T Z == Z[:D] — the random gather/scatter pair disappears.
        True for the id field of every MF-style dataset and the synthetic
        benchmark's id fields."""
        out = []
        for fi in range(pf.f):
            idx, val, D = pf.idx[fi], pf.val[fi], pf.Ds[fi]
            mt = pf.m_true
            ok = (
                idx.shape[1] == 1
                and D == mt
                and bool(np.all(idx[:mt, 0] == np.arange(mt)))
                and bool(np.all(val[:mt, 0] == 1))
                and bool(np.all(val[mt:, 0] == 0))
            )
            out.append(ok)
        return tuple(out)

    blk = blk_v = None
    if blocked_bm:
        import os as _os0

        from ..ops.sparse_ops import make_blocked_layout

        # OCFFM_BLK_PAD_RATIO: skew guard for the blocked layouts — a
        # power-user/popular-item block sets MAXC for everyone, and the
        # blocked passes stream n_blocks*MAXC slots vs the plain ops' nnz.
        ratio = float(_os0.environ.get("OCFFM_BLK_PAD_RATIO", 2.0))
        pads = np.asarray(y.w) == 0  # zero-weight entries occupy no slots
        # OCFFM_HEAD_CHUNK: chunk width of the two-tier skew layout's head
        # tier (0 disables the split — skewed sides then reject outright as
        # in round 3).  Since round 5 the head tier composes with the data
        # mesh too: head slots are chunk-dim arrays consumed at jit level
        # (outside the shard_map tail passes) — GSPMD partitions the small
        # head ops, whose outputs are per-head-row (NH bounded by the
        # layout's 1/8-of-rows cap) or (D, k) table terms it all-reduces.
        head_chunk = int(_os0.environ.get("OCFFM_HEAD_CHUNK", 512))
        # pad the chunk count so the chunk dim shards evenly on the mesh
        import math as _math0

        nch_mult = 8 * blocked_shards // _math0.gcd(8, blocked_shards)
        if blocked_shards > 1:
            blk = make_blocked_layout(
                y.u, y.v, u.m, blocked_bm, max_pad_ratio=ratio,
                shard_rows=u.m // blocked_shards, drop=pads,
                head_chunk=head_chunk, nch_multiple=nch_mult)
            # v side under the mesh: the layout's slot arrays shard on the
            # leading blocks dim (item rows ride the same data axis) and
            # the sharded blocked passes consume only slot-order data (the
            # residual carry makes coefficients elementwise) — so the
            # global src is assembly-time only and needs no shard locality.
            # blocked_bm must divide rows-per-shard (and shards must divide
            # v.m evenly) so blocks nest inside shards; the combined check
            # catches v.m not divisible by the shard count, which floor
            # division would let through (ADVICE r4).
            blk_v = None
            if (blk is not None
                    and v.m % (blocked_shards * blocked_bm) == 0):
                blk_v = make_blocked_layout(y.v, y.u, v.m, blocked_bm,
                                            max_pad_ratio=ratio, drop=pads,
                                            head_chunk=head_chunk,
                                            nch_multiple=nch_mult)
        else:
            blk = make_blocked_layout(y.u, y.v, u.m, blocked_bm,
                                      max_pad_ratio=ratio, drop=pads,
                                      head_chunk=head_chunk)
            blk_v = make_blocked_layout(y.v, y.u, v.m, blocked_bm,
                                        max_pad_ratio=ratio, drop=pads,
                                        head_chunk=head_chunk)

    meta = ProblemMeta(
        layout=layout,
        hp=hp,
        m=u.m,
        n=v.m,
        m_true=u.m_true,
        n_true=v.m_true,
        nnz=y.nnz,
        dtype=dtype,
        d_multiple=d_multiple,
        ident_u=ident_flags(u),
        ident_v=ident_flags(v),
        blocked_bm_u=blocked_bm if blk is not None else 0,
        blocked_bm_v=blocked_bm if blk_v is not None else 0,
        blocked_shards=blocked_shards if blk is not None else 1,
    )

    def regs(pf: PaddedFields):
        # pad value 1.0: pad table rows are exactly zero so any finite reg
        # weight contributes zero; 1.0 avoids 0-weight special cases
        def padded(arr):
            a = jnp.asarray(arr, dtype)
            dp = meta.pad_d(a.shape[0])
            return jnp.pad(a, (0, dp - a.shape[0]), constant_values=1.0)

        if hp.freq:
            return tuple(padded(fr) for fr in pf.freq)
        return tuple(jnp.ones(meta.pad_d(d), dtype) for d in pf.Ds)

    data = dict(
        xu_idx=tuple(jnp.asarray(a) for a in u.idx),
        xu_val=tuple(jnp.asarray(a, dtype) for a in u.val),
        xv_idx=tuple(jnp.asarray(a) for a in v.idx),
        xv_val=tuple(jnp.asarray(a, dtype) for a in v.val),
        pos_u=jnp.asarray(y.u),
        pos_v=jnp.asarray(y.v),
        pos_w=jnp.asarray(y.w, dtype),
        cnt_u=jnp.asarray(y.count_u, dtype),
        cnt_v=jnp.asarray(y.count_v, dtype),
        reg_u=None,
        reg_v=None,
    )
    data["reg_u"] = regs(u)
    data["reg_v"] = regs(v)

    def upload_blk(pre: str, b: dict, src_abs_key: bool):
        data[pre + "take"] = jnp.asarray(b["take"])
        data[pre + "src"] = jnp.asarray(b["src"])
        data[pre + "own"] = jnp.asarray(b["own"])
        # pre-permuted pad-mask weights: pos_w is static, so the per-CG-
        # iteration random scalar gather w[src] is paid once, here.
        # Masked to exactly 0 at structural pad slots (own == BM) — every
        # consumer's pad contributions already die via the all-zero one-hot
        # row, and the mask makes the array double as the slot-order pad
        # mask for the residual carry (OCFFM_BLK_YT).
        # (src_abs: the shard-local layout's src is slice-relative)
        data[pre + "w"] = jnp.asarray(
            y.w[b.get("src_abs", b["src"])]
            * (b["own"] < b["block_rows"]), dtype)
        data[pre + "inv"] = jnp.asarray(b["inv"])
        if src_abs_key and "src_abs" in b:
            # GLOBAL stream positions of the u slots (src is shard-local):
            # consumed by refresh_caches (stream yt -> slot carry) and the
            # cross-order maps; never read inside the hot passes.
            data[pre + "srcg"] = jnp.asarray(b["src_abs"])
        if "hd_row" in b:
            # two-tier head tier (skewed side): chunked slots of the power
            # rows' entries (see ops.make_blocked_layout head_chunk)
            data[pre + "hd_take"] = jnp.asarray(b["hd_take"])
            data[pre + "hd_src"] = jnp.asarray(b["hd_src"])
            data[pre + "hd_row"] = jnp.asarray(b["hd_row"])
            data[pre + "hd_loc"] = jnp.asarray(b["hd_loc"])
            data[pre + "hd_w"] = jnp.asarray(
                y.w[b["hd_src"]] * b["hd_valid"], dtype)

    if blk is not None:
        upload_blk("blk_u_", blk, True)
    if blk_v is not None:
        upload_blk("blk_v_", blk_v, False)

    import os as _os
    if (blk is not None and blk_v is not None
            and _os.environ.get("OCFFM_BLK_YT", "auto").lower()
            not in ("0", "off", "false")):
        # cross-order slot maps for the slot-order residual carry
        # (OCFFM_BLK_YT): for each slot of one side's layout, the FLAT slot
        # index of the same stream entry in the OTHER side's layout.  Static
        # — lets a gap computed flat in the solving side's order propagate
        # to the other side's carried residual with ONE scalar gather
        # (pad slots land anywhere; the blk_*_w mask kills them).  Skipped
        # when the carry is env-disabled (the solver gate keys on presence).
        # (inv maps are keyed by GLOBAL stream position, so the u side
        # indexes with src_abs when its src is shard-local.  Two-tier
        # sides: inv maps into the CONCATENATED flat slot space — tail
        # slots first, head slots after — and each tier of the receiving
        # side gets its own map.)
        data["blk_u_from_v"] = jnp.asarray(
            blk_v["inv"][blk.get("src_abs", blk["src"])])
        data["blk_v_from_u"] = jnp.asarray(blk["inv"][blk_v["src"]])
        if "hd_row" in blk:
            data["blk_u_hd_from_v"] = jnp.asarray(blk_v["inv"][blk["hd_src"]])
        if "hd_row" in blk_v:
            data["blk_v_hd_from_u"] = jnp.asarray(blk["inv"][blk_v["hd_src"]])
    return meta, data


# ---------------------------------------------------------------------------
# Sparse kernels: projection and scatter (the UTx / X^T z analogs)
# ---------------------------------------------------------------------------


# The gather-FMA / scatter-add pair at the heart of everything (reference
# UTx/UTX ffm.cpp:314-331 and the X^T z scatters), re-exported from
# ops.sparse_ops for callers.  pos_dot / pos_scatter are the COO positive-
# pass reductions with bounded (chunk, k) intermediates.
from ..ops.sparse_ops import (  # noqa: E402
    expand_rows_blocked,
    gather_blocked_rows,
    head_hv,
    head_pq,
    head_scatter,
    head_seg_sum,
    pos_dot,
    pos_gap_blocked,
    pos_hv_blocked,
    pos_scatter,
    pos_scatter_blocked,
    pos_scatter_pair,
    project,
    scatter,
    seg_sum_blocked,
    segment_sum,
)


def _device_bytes_limit() -> int:
    """Bytes one device may hold, for the pregather budget: OCFFM_HBM_GB
    when set (an explicit override), else the device's own
    ``memory_stats()["bytes_limit"]``.  The CPU reports none (0: no
    budget); a GPU that reports none is an error, not a guess."""
    import os

    env = os.environ.get("OCFFM_HBM_GB")
    if env is not None:
        return int(float(env) * (1 << 30))
    ms = jax.local_devices()[0].memory_stats() or {}
    limit = int(ms.get("bytes_limit", 0))
    if not limit and platform.backend() == "gpu":
        raise RuntimeError(
            "the GPU reports no memory_stats()['bytes_limit']; set "
            "OCFFM_HBM_GB to the device memory the solver may budget")
    return limit


# ---------------------------------------------------------------------------
# Solver
# ---------------------------------------------------------------------------


class FFMSolver:
    """Functional solver bound to one problem instance.

    Usage:
        solver = FFMSolver(meta, data)
        state = solver.init(jax.random.key(0))
        state = solver.epoch(state)          # jitted end-to-end
    """

    def __init__(self, meta: ProblemMeta, data: Dict[str, Any],
                 mesh=None, data_axis: str = "data"):
        self.meta = meta
        self.data = data
        self.mesh = mesh
        self.data_axis = data_axis
        if meta.blocked_shards > 1 and mesh is None:
            raise ValueError(
                "blocked_shards > 1 (shard-aligned blocked layout) requires "
                "constructing FFMSolver with mesh=")
        self.blocks: List[BlockInfo] = meta.layout.all_blocks()
        # "auto" (round 5): PLAIN CG — the reference's exact solver
        # (ffm.cpp:744-813).  Jacobi-PCG was the default through round 4
        # (fewer iterations, toy-tier metric parity 36/36), but the
        # sweep-scale tier exposed it changing the REACHABLE 100-epoch
        # state under the reference's capped (20), loose-eps (0.09)
        # solves: -7.7% p@5 one-sided at the KKBox k=64 cell and -51%
        # p@5 at the k=16 fm-fm--ns cell (ploss LOWER — the diag
        # preconditioner down-weights shared high-curvature features, so
        # the model memorizes per-id scores and ranks worse), both
        # reproduced at f64 (not precision) and both ELIMINATED exactly
        # by plain CG (docs/PARITY.md, k64 diagnosis).  "jacobi" remains
        # an explicit opt-in.
        self.cg_precond = meta.hp.cg_precond
        if self.cg_precond == "auto":
            self.cg_precond = "none"
        # Per-solve pre-gather of the blocked stream's B rows
        # (ops.gather_blocked_rows): B is constant across a solve, so the
        # random gather is paid once and the grad + every CG iteration
        # stream the result sequentially.  Gated by the materialized
        # stream's device footprint.
        import os as _os
        mode = _os.environ.get("OCFFM_BLK_PREGATHER", "auto").lower()
        # per-stream cap (default 400 MiB): the epoch program can hold
        # several solves' streams live at once.  An EXPLICIT
        # OCFFM_BLK_PREGATHER_MB wins outright (measurement override).
        cap_env = _os.environ.get("OCFFM_BLK_PREGATHER_MB")
        cap = (int(cap_env) if cap_env is not None else 400) << 20
        # device-memory budget, computed STATICALLY from the problem shapes
        # (logical bytes) and the device's byte limit, so identical configs
        # always take identical code paths.  The materialized stream must
        # leave room for the problem arrays, the state (tables + caches),
        # one solve's update transients (the input state is DONATED, so
        # only the block being replaced is live twice) and the biggest
        # table's f32 CG vector set.
        total_bytes = _device_bytes_limit()
        budget = None
        if total_bytes > 0 and cap_env is None:
            k = meta.hp.k
            isz_ = jnp.dtype(meta.dtype).itemsize
            state_b = 0
            max_d = 1
            trans_b = 0  # largest single solve's table+cache replacement
            for bi in self.blocks:
                rows1 = meta.m if bi.f1 < meta.layout.fu else meta.n
                rows2 = meta.m if bi.f2 < meta.layout.fu else meta.n
                state_b += (meta.pad_d(bi.d1) + meta.pad_d(bi.d2)
                            + rows1 + rows2) * k * isz_
                max_d = max(max_d, meta.pad_d(bi.d1), meta.pad_d(bi.d2))
                trans_b = max(
                    trans_b,
                    (meta.pad_d(bi.d1) + rows1) * k * isz_,
                    (meta.pad_d(bi.d2) + rows2) * k * isz_)
            state_b += 2 * meta.nnz * isz_
            data_b = sum(a.size * a.dtype.itemsize
                         for a in jax.tree.leaves(data))
            cg_b = 5 * k * max_d * 4  # S/R/V/G/Hv at the f32 CG floor
            budget = total_bytes - data_b - state_b - trans_b - cg_b
            cap = min(cap, max(0, budget) // 2)
        self.pregather_cap = cap
        self._gate_log = _os.environ.get(
            "OCFFM_DEBUG_GATES", "0").lower() in ("1", "on", "true")
        if self._gate_log:
            print(f"[ocffm gates] pregather_cap={cap >> 20}MB "
                  f"(device={total_bytes >> 20}MB, budget="
                  f"{'n/a' if budget is None else budget >> 20}MB)")

        # OCFFM_BLK_PREGATHER_SIDE: restrict the per-solve stream
        # materialization to one segment side ("u"/"v"; default both) —
        # halves the LIVE stream footprint where the state + CG vectors
        # leave room for only one side's stream
        side_env = _os.environ.get("OCFFM_BLK_PREGATHER_SIDE", "").lower()

        def pregather_ok(side_bm: int, take_key: str) -> bool:
            if not side_bm or take_key not in data or mode in (
                    "0", "off", "false"):
                return False
            if side_env in ("u", "v") and not take_key.startswith(
                    f"blk_{side_env}_"):
                return False
            if mesh is not None and meta.blocked_shards == 1:
                # mesh runs keep the plain GSPMD-shardable ops (the
                # shard-aligned blocked path forces its own pregather)
                return False
            if mode in ("1", "on", "true"):
                return True
            nb, maxc = data[take_key].shape
            nbytes = nb * maxc * meta.hp.k * jnp.dtype(meta.dtype).itemsize
            # the head tier's stream is gathered alongside — count it
            # against the same cap
            hd_key = take_key.replace("take", "hd_take")
            if hd_key in data:
                nch, chunk = data[hd_key].shape
                nbytes += (nch * chunk * meta.hp.k
                           * jnp.dtype(meta.dtype).itemsize)
            return nbytes <= cap

        self.pregather_u = pregather_ok(meta.blocked_bm_u, "blk_u_take")
        self.pregather_v = pregather_ok(meta.blocked_bm_v, "blk_v_take")
        if meta.blocked_shards > 1:
            # the shard_map-local blocked ops have no access to the (row-
            # sharded) B table — the pre-gathered stream is mandatory
            self.pregather_u = True
        # Blocked residual gap (ops.pos_gap_blocked): with the solve's
        # pre-gathered stream in hand, the update pass's two per-stream
        # random row gathers (the plain pos_dot "gaps" form) collapse to
        # sequential streaming + one-hot matmuls + an (nnz,) scalar
        # permute.  Rides the pregather decision.
        gmode = _os.environ.get("OCFFM_BLK_GAP", "auto").lower()
        gap_want = gmode not in ("0", "off", "false")
        # Slot-order residual carry (OCFFM_BLK_YT, default "auto"): carry yt
        # in BOTH sides' blocked slot orders instead of stream order.  The
        # gradient coefficient c = pos_coeff(yt) * w then never needs the
        # per-solve (nnz,) random scalar gather c[src] — it is elementwise on
        # the carried array — and the gap pass skips its inverse permute on
        # the solving side (only the propagation to the OTHER side's order
        # pays one static scalar gather).  Values are bit-identical to the
        # stream carry: the same floats live at permuted positions.
        # Requires every solve to run fully blocked: both layouts present,
        # pre-gather on both sides, the blocked gap.
        ymode = _os.environ.get("OCFFM_BLK_YT", "auto").lower()
        yt_want = ymode not in ("0", "off", "false")
        if meta.blocked_shards > 1:
            # Under the mesh the shard_map-local blocked passes consume
            # SLOT-ORDER coefficients, so the v side needs the carry (a
            # stream-order c[src] gather with the v side's global src would
            # cross shards inside the pass).  With the carry: u and v passes
            # run shard-locally, the gap lands flat in the solving side's
            # slot sharding, and only the cross-order propagation + the
            # per-solve B-row all-gather touch the interconnect.
            self.blk_yt = bool(yt_want and gap_want
                               and meta.blocked_bm_u and meta.blocked_bm_v
                               and "blk_u_from_v" in data
                               and self.pregather_v)
            self.blk_gap = self.blk_yt
            if not self.blk_yt:
                # sharded fallback: u-side blocked under shard_map
                # (stream-order c, shard-local src), v side plain GSPMD COO
                self.pregather_v = False
        else:
            self.blk_gap = gap_want
            self.blk_yt = (yt_want and self.blk_gap
                           and self.pregather_u and self.pregather_v
                           and "blk_u_from_v" in data)
        # which sides' blocked layouts are CONSUMED at runtime (under the
        # sharded fallback the v layout exists in data but must not be
        # used: its blocked passes would gather B rows inside a fori_loop
        # through GSPMD)
        self.blk_u_on = bool(meta.blocked_bm_u)
        self.blk_v_on = bool(meta.blocked_bm_v) and (
            meta.blocked_shards == 1 or self.blk_yt)
        # two-tier head tiers (skew split, single-shard only): whenever a
        # side's TAIL blocked arrays are consumed, its head contributions
        # must be added too — the tail layout was built with the head
        # entries dropped (ops.make_blocked_layout head_chunk)
        self.hd_u = "blk_u_hd_row" in data
        self.hd_v = "blk_v_hd_row" in data
        if self._gate_log and (self.hd_u or self.hd_v):
            for side, on in (("u", self.hd_u), ("v", self.hd_v)):
                if on:
                    t = data[f"blk_{side}_hd_take"]
                    print(f"[ocffm gates] head tier {side}: "
                          f"{t.shape[0]} chunks x {t.shape[1]} "
                          f"(tail maxc {data['blk_' + side + '_own'].shape[1]})")
        # residual array to sync/inspect on (bench, profiling scripts)
        self.yt_key = "yt_u" if self.blk_yt else "yt"
        # donate the carried state: P/Q/a/b/yt buffers are dead after the
        # epoch returns their successors (no-op on backends without donation)
        self._epoch = jax.jit(self._bound(self._epoch_impl),
                              donate_argnums=(0,))
        self._objective = jax.jit(self._bound(self._objective_impl))
        self._refresh = jax.jit(self._bound(self._refresh_impl))
        self._grad_hv = jax.jit(self._bound(self._grad_hv_impl))

    def _bound(self, impl):
        """Jit entry for ``impl(arg)``: the problem arrays are a runtime
        argument (not baked constants) so their shardings drive GSPMD
        partitioning and the executable stays small, and every dot traces
        at the storage dtype's matmul precision (platform.precision_scope:
        f32 means f32, not TF32)."""

        def entry(arg, data):
            prev = self.data
            self.data = data
            try:
                with platform.precision_scope(self.meta.dtype):
                    return impl(arg)
            finally:
                self.data = prev

        return entry

    # -- field array accessors ------------------------------------------------

    def _side_arrays(self, b: BlockInfo, first: bool):
        """(idx, val, reg, rows) for the block's f1 (first) or f2 side."""
        fg = b.f1 if first else b.f2
        fl = b.fi if first else b.fj
        d = self.data
        if fg < self.meta.layout.fu:
            return d["xu_idx"][fl], d["xu_val"][fl], d["reg_u"][fl], self.meta.m
        return d["xv_idx"][fl], d["xv_val"][fl], d["reg_v"][fl], self.meta.n

    def _hd_side(self, u_side: bool) -> bool:
        """Head tier present on the u (True) / v (False) segment side."""
        return self.hd_u if u_side else self.hd_v

    def _hd_coeff(self, state, u_side: bool) -> Array:
        """Gradient coefficients on the head tier's slots (NCH, CHUNK) —
        elementwise on the carried head residual, or a stream-order scalar
        gather outside the carry mode (mirrors the tail's c[src])."""
        pre = "blk_u_hd_" if u_side else "blk_v_hd_"
        d = self.data
        if self.blk_yt:
            yt_hd = state["yt_u_hd" if u_side else "yt_v_hd"]
            return self._pos_coeff(yt_hd) * d[pre + "w"]
        c = self._pos_coeff(state["yt"]) * d["pos_w"]
        # pad slots gather position 0 (a REAL entry) — unlike the tail there
        # is no all-zero one-hot row to kill them, so mask via the head
        # weights (w is the 1/0 pad mask; idempotent on real entries)
        return c[d[pre + "src"]] * d[pre + "w"]

    def _side_ident(self, b: BlockInfo, first: bool):
        """(is_identity, padded_rows, true_rows) for the block side."""
        fg = b.f1 if first else b.f2
        fl = b.fi if first else b.fj
        meta = self.meta
        if fg < meta.layout.fu:
            ident = meta.ident_u[fl] if fl < len(meta.ident_u) else False
            return ident, meta.m, meta.m_true
        ident = meta.ident_v[fl] if fl < len(meta.ident_v) else False
        return ident, meta.n, meta.n_true

    def _proj(self, b: BlockInfo, first: bool, T: Array) -> Array:
        """X_side @ T.  Identity fields skip the random gather entirely:
        X is the identity over true rows, so the projection is the table
        itself zero-padded to the row count (table pad rows are zero by
        invariant)."""
        ident, rows, _ = self._side_ident(b, first)
        if ident and T.shape[0] <= rows:
            if T.shape[0] == rows:
                return T
            return jnp.pad(T, ((0, rows - T.shape[0]), (0, 0)))
        i1, v1, _, _ = self._side_arrays(b, first)
        return project(i1, v1, T)

    def _scat(self, b: BlockInfo, first: bool, Z: Array, dim: int) -> Array:
        """X_side^T @ Z.  Identity fields: a slice (row d receives exactly
        row d's contribution), masking any table pad rows — data pad rows
        carry nonzero omega terms that val==0 drops in the general path."""
        ident, rows, rows_true = self._side_ident(b, first)
        if ident and dim <= Z.shape[0]:
            G = Z[:dim]
            if dim > rows_true:
                G = G * (jnp.arange(dim) < rows_true)[:, None].astype(G.dtype)
            return G
        i1, v1, _, _ = self._side_arrays(b, first)
        return scatter(i1, v1, Z, dim)

    # -- init -----------------------------------------------------------------

    def init(self, key: Array) -> Dict[str, Any]:
        """Random block tables + all caches (reference init, ffm.cpp:467-512).

        Tables ~ U(-0.1/sqrt(k), 0.1/sqrt(k)) (init_mat, ffm.cpp:71-78).
        One jitted program for all tables (cheap dispatch on remote backends).
        """

        @jax.jit
        def init_params(key):
            meta = self.meta
            k = meta.hp.k
            scale = 0.1 / np.sqrt(k)

            def table(key, d_true, d_pad):
                t = jax.random.uniform(
                    key, (d_pad, k), meta.dtype, minval=-scale, maxval=scale
                )
                if d_pad == d_true:
                    return t
                # zero the pad rows: never indexed, zero gradient, CG keeps
                # them zero — the table-padding invariant (see pad_d)
                rows = jnp.arange(d_pad)[:, None] < d_true
                return jnp.where(rows, t, 0.0)

            params: Dict[int, Dict[str, Array]] = {}
            for b in self.blocks:
                key, k1, k2 = jax.random.split(key, 3)
                params[b.f12] = dict(
                    W=table(k1, b.d1, meta.pad_d(b.d1)),
                    H=table(k2, b.d2, meta.pad_d(b.d2)),
                )
            return params

        return self.refresh_caches({"params": init_params(key)})

    def refresh_caches(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """(Re)build P/Q, side sums a/b and the positive residual yt from
        params — used at init and after loading a checkpoint.  Jitted as one
        program (eager per-op dispatch is expensive on remote backends)."""
        return self._refresh(state["params"], self.data)

    def _refresh_impl(self, params) -> Dict[str, Any]:
        P, Q = {}, {}
        for b in self.blocks:
            P[b.f12] = self._proj(b, True, params[b.f12]["W"])
            Q[b.f12] = self._proj(b, False, params[b.f12]["H"])
        a, b_vec = self._side_sums(P, Q)
        yt = self._pos_scores(P, Q, a, b_vec) - 1.0
        if not self.blk_yt:
            return dict(params=params, P=P, Q=Q, a=a, b=b_vec, yt=yt)
        # slot-order carry: the stream residual permuted into each side's
        # blocked layout (one-time gathers; epochs then never touch stream
        # order).  The blk_*_w multiply zeroes structural pad slots.
        d = self.data
        out = dict(
            params=params, P=P, Q=Q, a=a, b=b_vec,
            # srcg: global stream positions (the sharded u layout's src is
            # shard-local); a one-time gather, never in the hot passes
            yt_u=yt[d.get("blk_u_srcg", d["blk_u_src"])] * d["blk_u_w"],
            yt_v=yt[d["blk_v_src"]] * d["blk_v_w"],
        )
        if self.hd_u:
            out["yt_u_hd"] = yt[d["blk_u_hd_src"]] * d["blk_u_hd_w"]
        if self.hd_v:
            out["yt_v_hd"] = yt[d["blk_v_hd_src"]] * d["blk_v_hd_w"]
        return out

    def yt_stream(self, state) -> Array:
        """The positive-stream residual in ORIGINAL stream order, pad-masked
        (x pos_w) — stream order is diagnostics-only under the slot-order
        carry (every consumer of yt multiplies by the pad mask anyway)."""
        d = self.data
        if "yt" in state:
            return state["yt"] * d["pos_w"]
        flat = state["yt_u"].reshape(-1)
        if self.hd_u:
            # two-tier: inv maps into the concatenated (tail, head) space
            flat = jnp.concatenate([flat, state["yt_u_hd"].reshape(-1)])
        return flat[d["blk_u_inv"]] * d["pos_w"]

    def _side_sums(self, P, Q) -> Tuple[Array, Array]:
        """a_i / b_j self-interaction sums (calc_side, ffm.cpp:360-373)."""
        meta = self.meta
        a = jnp.zeros(meta.m, meta.dtype)
        b_vec = jnp.zeros(meta.n, meta.dtype)
        for blk in meta.layout.user_self_blocks():
            a = a + jnp.sum(P[blk.f12] * Q[blk.f12], axis=1)
        for blk in meta.layout.item_self_blocks():
            b_vec = b_vec + jnp.sum(P[blk.f12] * Q[blk.f12], axis=1)
        return a, b_vec

    def _pos_scores(self, P, Q, a, b_vec) -> Array:
        """yhat at every positive pair (init_y_tilde, ffm.cpp:388-403)."""
        d = self.data
        u, v = d["pos_u"], d["pos_v"]
        z = a[u] + b_vec[v]
        for blk in self.meta.layout.cross_blocks():
            z = z + pos_dot(P[blk.f12], u, Q[blk.f12], v)
        return z

    # -- ω-term rank-k caches -------------------------------------------------

    def _cache_sasb(self, P, Q) -> Tuple[Array, Array]:
        """sa_i = sum_j cross(i,j), sb_j = sum_i cross(i,j) via (Q^T 1) chains
        (cache_sasb, ffm.cpp:514-535) — O((m+n)k) per cross block."""
        meta = self.meta
        sa = jnp.zeros(meta.m, meta.dtype)
        sb = jnp.zeros(meta.n, meta.dtype)
        for blk in meta.layout.cross_blocks():
            Pb, Qb = P[blk.f12], Q[blk.f12]
            sa = sa + Pb @ jnp.sum(Qb, axis=0)
            sb = sb + Qb @ jnp.sum(Pb, axis=0)
        return sa, sb

    # -- gradients ------------------------------------------------------------

    def _pos_coeff(self, yt: Array) -> Array:
        """Per-positive gradient coefficient (1-w)*yt - w*(1-r): the exact
        decomposition the reference uses everywhere (ffm.cpp:577-579,684)."""
        hp = self.meta.hp
        return (1.0 - hp.omega) * yt - hp.omega * (1.0 - hp.r)

    def _grad_self(self, state, b: BlockInfo, first: bool, sa, sb):
        """Gradient for one table of a self block (gd_side, ffm.cpp:537-592).

        z_i = w [ n (a_i - r) + sum(b) + sa_i ] + sum_{j in pos_i} c_ij
        G   = lam * reg * T + X1^T diag(z) Q1"""
        meta, d = self.meta, self.data
        hp = meta.hp
        f12 = b.f12
        i1, v1, reg, rows = self._side_arrays(b, first)
        T = state["params"][f12]["W" if first else "H"]
        Q1 = state["Q"][f12] if first else state["P"][f12]
        # Padded rows of a/b/P/Q are exactly zero, so full-array sums equal
        # true-row sums — keeps every reduction GSPMD-shardable.
        if b.kind == "uu":
            n_other, side, s_cache = meta.n_true, state["a"], sa
            other_sum = jnp.sum(state["b"])
            pre, num, yt_key = "blk_u_", meta.m, "yt_u"
        else:  # vv
            n_other, side, s_cache = meta.m_true, state["b"], sb
            other_sum = jnp.sum(state["a"])
            pre, num, yt_key = "blk_v_", meta.n, "yt_v"
        if self.blk_yt:
            # slot-order carry: c is elementwise on the carried residual and
            # the per-row sum streams sequentially — no random access
            cb = self._pos_coeff(state[yt_key]) * d[pre + "w"]
            if meta.blocked_shards > 1:
                zpos = self._seg_sum_blocked_sharded(b.kind == "uu", cb)
            else:
                zpos = seg_sum_blocked(
                    cb, d[pre + "own"], num,
                    meta.blocked_bm_u if b.kind == "uu"
                    else meta.blocked_bm_v)
            if self._hd_side(b.kind == "uu"):
                # the tail slots dropped the head rows' entries — add their
                # per-row sums in BOTH the sharded and single-shard branches
                zpos = zpos + head_seg_sum(
                    self._hd_coeff(state, b.kind == "uu"),
                    d[pre + "hd_row"], num)
        else:
            c = self._pos_coeff(state["yt"]) * d["pos_w"]
            zpos = segment_sum(
                c, d["pos_u" if b.kind == "uu" else "pos_v"], num,
                sorted_ids=(b.kind == "uu")).astype(c.dtype)
        z = hp.omega * (n_other * (side - hp.r) + other_sum + s_cache) + zpos
        G = hp.lam * reg[:, None] * T + self._scat(
            b, first, z[:, None] * Q1, T.shape[0]
        )
        return G

    # -- shard-aligned blocked positive passes (blocked_shards > 1) ----------
    #
    # The shard-aligned stream (pad_labels shard_rows=) puts every user
    # row's positives on the row's own shard, and the blocked layout's src
    # is shard-LOCAL — so the u-side blocked passes need no communication
    # at all: shard_map runs the identical per-block one-hot math
    # device-locally.  Under the slot-order
    # carry the v side runs shard-locally too: every consumed array is in
    # slot order (coefficients elementwise on the carried residual, rows
    # pre-gathered, weights pre-permuted), sharded on the blocks dim.  The
    # collective budget of a sharded solve: the all-gather hidden in the
    # once-per-solve rows_pre gather (B is row-sharded), the table-space
    # all-reduce of each X^T scatter, the carry's cross-order propagation
    # gather, and the k x k Gram psums GSPMD already inserts.

    def _shard_specs(self):
        from jax.sharding import PartitionSpec as P

        ax = self.data_axis
        return P(ax), P(ax, None), P(ax, None, None), P()

    def _shard_local(self, fn, args_specs, out_specs):
        """Run a blocked-op call shard-locally under shard_map.

        ``args_specs``: [(array, spec), ...] with spec one of
          "v"  (ax,)            sharded vector / flat slot array
          "m2" (ax, None)       rows- or blocks-leading 2-D
          "m3" (ax, None, None) the pre-gathered stream
          "r"  replicated
        ``out_specs``: spec or tuple of specs."""
        from jax.sharding import PartitionSpec as P

        ax = self.data_axis
        S = dict(v=P(ax), m2=P(ax, None), m3=P(ax, None, None), r=P())
        args = tuple(a for a, _ in args_specs)
        in_specs = tuple(S[s] for _, s in args_specs)
        outs = (tuple(S[s] for s in out_specs)
                if isinstance(out_specs, tuple) else S[out_specs])
        wrapped = jax.shard_map(fn, mesh=self.mesh, in_specs=in_specs,
                                out_specs=outs, check_vma=False)
        return wrapped(*args)

    def _scatter_blocked_sharded(self, first: bool, c, rows_pre,
                                 wq_blk=None, c_blk=None):
        """The blocked gradient scatter under shard_map.

        ``c`` (stream order, u side only — shard-local src) or ``c_blk``
        (slot order, either side — the carry mode).  ``wq_blk``:
        pre-permuted diag weights."""
        meta, d = self.meta, self.data
        pre = "blk_u_" if first else "blk_v_"
        num_l = (meta.m if first else meta.n) // meta.blocked_shards
        BM = meta.blocked_bm_u if first else meta.blocked_bm_v
        with_diag = wq_blk is not None
        out_specs = ("m2", "m2") if with_diag else "m2"
        if c_blk is not None:
            def local(cb_l, own_l, rows_l, wq_l):
                return pos_scatter_blocked(
                    None, None, None, None, own_l, num_l, BM,
                    diag_w_blk=wq_l if with_diag else None,
                    rows=rows_l, coeff_blk=cb_l)

            return self._shard_local(
                local,
                [(c_blk, "m2"), (d[pre + "own"], "m2"), (rows_pre, "m3"),
                 (wq_blk if with_diag else d[pre + "w"], "m2")],
                out_specs)
        assert first, "stream-order c is the u-side fallback"

        def local(c_l, src_l, own_l, rows_l, wq_l):
            return pos_scatter_blocked(
                c_l, None, None, src_l, own_l, num_l, BM,
                diag_w_blk=wq_l if with_diag else None, rows=rows_l)

        return self._shard_local(
            local,
            [(c, "v"), (d["blk_u_src"], "m2"), (d["blk_u_own"], "m2"),
             (rows_pre, "m3"),
             (wq_blk if with_diag else d["blk_u_w"], "m2")],
            out_specs)

    def _hv_blocked_sharded(self, first: bool, phi, rows_pre, dmat,
                            w_scale):
        """The blocked per-CG-iteration positive + fused omega pass under
        shard_map."""
        meta, d = self.meta, self.data
        pre = "blk_u_" if first else "blk_v_"
        num_l = (meta.m if first else meta.n) // meta.blocked_shards
        BM = meta.blocked_bm_u if first else meta.blocked_bm_v

        def local(phi_l, own_l, rows_l, w_l, dm):
            return pos_hv_blocked(
                phi_l, None, None, None, None, own_l, num_l, BM,
                rows=rows_l, w_blk=w_l, w_scale=w_scale, dense_mat=dm)

        return self._shard_local(
            local,
            [(phi, "m2"), (d[pre + "own"], "m2"), (rows_pre, "m3"),
             (d[pre + "w"], "m2"), (dmat, "r")],
            "m2")

    def _gap_blocked_sharded(self, first: bool, dT, rows_pre):
        """The blocked residual gap under shard_map: returns the FLAT
        slot-order gap, sharded over the data axis (block-nested slots)."""
        meta, d = self.meta, self.data
        pre = "blk_u_" if first else "blk_v_"
        BM = meta.blocked_bm_u if first else meta.blocked_bm_v

        def local(dT_l, own_l, rows_l):
            return pos_gap_blocked(dT_l, rows_l, own_l, None, BM)

        return self._shard_local(
            local,
            [(dT, "m2"), (d[pre + "own"], "m2"), (rows_pre, "m3")],
            "v")

    def _seg_sum_blocked_sharded(self, first: bool, c_blk):
        """seg_sum_blocked (per-row sums of slot-order values) under
        shard_map."""
        meta, d = self.meta, self.data
        pre = "blk_u_" if first else "blk_v_"
        num_l = (meta.m if first else meta.n) // meta.blocked_shards
        BM = meta.blocked_bm_u if first else meta.blocked_bm_v

        def local(cb_l, own_l):
            return seg_sum_blocked(cb_l, own_l, num_l, BM)

        return self._shard_local(
            local, [(c_blk, "m2"), (d[pre + "own"], "m2")], "v")

    def _expand_rows_sharded(self, first: bool, vec):
        """expand_rows_blocked (per-slot copy of a per-row vector) under
        shard_map: flat slot-order output, data-sharded."""
        meta, d = self.meta, self.data
        pre = "blk_u_" if first else "blk_v_"
        BM = meta.blocked_bm_u if first else meta.blocked_bm_v

        def local(v_l, own_l):
            return expand_rows_blocked(v_l, own_l, BM)

        return self._shard_local(
            local, [(vec, "v"), (d[pre + "own"], "m2")], "v")

    def _grad_cross(self, state, b: BlockInfo, first: bool,
                    with_diag_pos: bool = False, rows_pre=None,
                    rows_hd=None):
        """Gradient for one table of a cross block (gd_cross, ffm.cpp:630-703).

        omega part via k x k Grams: T = sum_c P_c (Q_c^T Q1), oQ = Q1^T 1,
        bQ = Q1^T b  (ffm.cpp:658-670); positive part via segment_sum.

        ``with_diag_pos``: also return the Jacobi diagonal's positive term
        (sum_t (1-w) w_t Q1[o_t]^2 per row) from the SAME gather — one
        fused (chunk, 2k) pass instead of two positive passes
        (ops.pos_scatter_pair); per-column add order is identical, so the
        gradient is bit-equal to the unfused path."""
        meta, d = self.meta, self.data
        hp = meta.hp
        f12 = b.f12
        i1, v1, reg, rows = self._side_arrays(b, first)
        T = state["params"][f12]["W" if first else "H"]
        if self.blk_yt:
            # slot-order carry: the coefficient is elementwise on the carried
            # residual — the (nnz,) random scalar gather c[src] disappears
            pre_c = "blk_u_" if first else "blk_v_"
            c = None
            c_blk = self._pos_coeff(state["yt_u" if first else "yt_v"]) \
                * d[pre_c + "w"]
        else:
            c = self._pos_coeff(state["yt"]) * d["pos_w"]
            c_blk = None

        def hd_rowspace(zpos, posq, num, pre_h):
            """Head-tier additions in row space for the blocked gradient
            branches — the tail pass dropped the head entries."""
            if rows_hd is None:
                return zpos, posq
            wq_hd = ((1.0 - hp.omega) * d[pre_h + "w"]
                     if with_diag_pos else None)
            res_h = head_scatter(self._hd_coeff(state, first), rows_hd,
                                 d[pre_h + "row"], num, diag_w_hd=wq_hd)
            if with_diag_pos:
                return zpos + res_h[0], posq + res_h[1]
            return zpos + res_h, posq

        if first:
            Q1 = state["Q"][f12]  # (n, k)
            oQ = jnp.sum(Q1, axis=0)
            bQ = Q1.T @ state["b"]
            gram_T = jnp.zeros((meta.m, hp.k), meta.dtype)
            for blk in meta.layout.cross_blocks():
                gram = state["Q"][blk.f12].T @ Q1  # (k, k)
                gram_T = gram_T + state["P"][blk.f12] @ gram
            dense = hp.omega * (
                (state["a"] - hp.r)[:, None] * oQ[None, :] + bQ[None, :] + gram_T
            )
            if self.blk_u_on and (rows_pre is not None
                                  or not with_diag_pos):
                # blocked layout: segment-sum as block matmuls.  Without
                # pre-gathered rows the Jacobi diag keeps the fused
                # pos_scatter_pair (one random gather feeds both
                # payloads); with rows_pre the stream is read sequentially
                # and the blocked double payload takes both.
                # the diag weights are STATIC ((1-w) * pad mask): use the
                # pre-permuted blk_w instead of a per-solve wq[src] gather
                wq_blk = ((1.0 - hp.omega) * d["blk_u_w"]
                          if with_diag_pos else None)
                if meta.blocked_shards > 1:
                    res = self._scatter_blocked_sharded(
                        True, c, rows_pre, wq_blk=wq_blk, c_blk=c_blk)
                    zpos, posq = res if with_diag_pos else (res, None)
                else:
                    res = pos_scatter_blocked(
                        c, Q1, d["blk_u_take"], d["blk_u_src"],
                        d["blk_u_own"], meta.m, meta.blocked_bm_u,
                        diag_w_blk=wq_blk, rows=rows_pre, coeff_blk=c_blk)
                    zpos, posq = res if with_diag_pos else (res, None)
                zpos, posq = hd_rowspace(zpos, posq, meta.m, "blk_u_hd_")
            elif with_diag_pos:
                assert c is not None, "slot carry requires the blocked path"
                wq = (1.0 - hp.omega) * d["pos_w"]
                zpos, posq = pos_scatter_pair(
                    c, wq, Q1, d["pos_v"], d["pos_u"], meta.m, seg_sorted=True)
            else:
                assert c is not None, "slot carry requires the blocked path"
                zpos = pos_scatter(c, Q1, d["pos_v"], d["pos_u"], meta.m,
                                   seg_sorted=True)
        else:
            P1 = state["P"][f12]  # (m, k)
            oQ = jnp.sum(P1, axis=0)
            bQ = P1.T @ state["a"]
            gram_T = jnp.zeros((meta.n, hp.k), meta.dtype)
            for blk in meta.layout.cross_blocks():
                gram = state["P"][blk.f12].T @ P1
                gram_T = gram_T + state["Q"][blk.f12] @ gram
            dense = hp.omega * (
                (state["b"] - hp.r)[:, None] * oQ[None, :] + bQ[None, :] + gram_T
            )
            if self.blk_v_on and (rows_pre is not None
                                  or not with_diag_pos):
                wq_blk = ((1.0 - hp.omega) * d["blk_v_w"]
                          if with_diag_pos else None)
                if meta.blocked_shards > 1:
                    res = self._scatter_blocked_sharded(
                        False, None, rows_pre, wq_blk=wq_blk, c_blk=c_blk)
                    zpos, posq = res if with_diag_pos else (res, None)
                else:
                    res = pos_scatter_blocked(
                        c, P1, d["blk_v_take"], d["blk_v_src"],
                        d["blk_v_own"], meta.n, meta.blocked_bm_v,
                        diag_w_blk=wq_blk, rows=rows_pre, coeff_blk=c_blk)
                    zpos, posq = res if with_diag_pos else (res, None)
                zpos, posq = hd_rowspace(zpos, posq, meta.n, "blk_v_hd_")
            elif with_diag_pos:
                assert c is not None, "slot carry requires the blocked path"
                wq = (1.0 - hp.omega) * d["pos_w"]
                zpos, posq = pos_scatter_pair(
                    c, wq, P1, d["pos_u"], d["pos_v"], meta.n)
            else:
                assert c is not None, "slot carry requires the blocked path"
                zpos = pos_scatter(c, P1, d["pos_u"], d["pos_v"], meta.n)
        Z = dense + zpos
        G = hp.lam * reg[:, None] * T + self._scat(b, first, Z, T.shape[0])
        if with_diag_pos:
            return G, posq
        return G

    # -- Hessian-vector products ---------------------------------------------

    def _hv_self(self, state, b: BlockInfo, first: bool):
        """Hv closure for a self-block table (hs_side, ffm.cpp:594-628):
        d_i = (1-w)|pos_i| + w*n;  Hv = lam reg V + X1^T diag(d <Q1,Phi>) Q1.
        """
        meta, d = self.meta, self.data
        hp = meta.hp
        i1, v1, reg, rows = self._side_arrays(b, first)
        Q1 = state["Q"][b.f12] if first else state["P"][b.f12]
        if b.kind == "uu":
            dd = (1.0 - hp.omega) * d["cnt_u"] + hp.omega * meta.n_true
        else:
            dd = (1.0 - hp.omega) * d["cnt_v"] + hp.omega * meta.m_true
        dim = (state["params"][b.f12]["W" if first else "H"]).shape[0]

        def hv(V: Array) -> Array:
            phi = self._proj(b, first, V)
            s = dd * jnp.sum(Q1 * phi, axis=1)
            return hp.lam * reg[:, None] * V + self._scat(
                b, first, s[:, None] * Q1, dim
            )

        return hv

    def _hv_cross(self, state, b: BlockInfo, first: bool, rows_pre=None,
                  rows_hd=None):
        """Hv closure for a cross-block table (hs_cross, ffm.cpp:706-742):
        omega part via precomputed Q1^T Q1 (ffm.cpp:767-771); (1-w) part per
        positive."""
        meta, d = self.meta, self.data
        hp = meta.hp
        i1, v1, reg, rows = self._side_arrays(b, first)
        if first:
            Q1 = state["Q"][b.f12]
            own, other = d["pos_u"], d["pos_v"]
            num = meta.m
        else:
            Q1 = state["P"][b.f12]
            own, other = d["pos_v"], d["pos_u"]
            num = meta.n
        QTQ = Q1.T @ Q1  # pad rows are zero; full Gram == true-row Gram
        dim = (state["params"][b.f12]["W" if first else "H"]).shape[0]
        w_pos = d["pos_w"]

        if meta.blocked_shards > 1 and (self.blk_u_on if first
                                        else self.blk_v_on):
            # shard-aligned blocked layout under the data mesh: the pass
            # runs shard-locally on the pre-gathered stream (no
            # per-iteration collectives), with the omega term
            # phi @ (omega QTQ) fused in (dense_mat) and the static weights
            # pre-permuted (blk_*_w)
            pre = "blk_u_" if first else "blk_v_"
            w_scale = 1.0 - hp.omega
            dmat = (hp.omega * QTQ).astype(meta.dtype)

            def hv_sharded(V: Array) -> Array:
                phi = self._proj(b, first, V)  # (rows, k)
                zp = self._hv_blocked_sharded(
                    first, phi, rows_pre, dmat, w_scale)
                if rows_hd is not None:
                    zp = zp + head_hv(
                        phi, rows_hd, d[pre + "hd_w"],
                        d[pre + "hd_row"], num, w_scale=w_scale)
                return hp.lam * reg[:, None] * V + self._scat(
                    b, first, zp, dim)

            return hv_sharded

        # On one device the CG pass is the plain COO form whatever the
        # stream layout: XLA's native gather and scatter-add beat the
        # per-block one-hot form (a sequential loop over the blocks) by far
        # on the GPU, and the hand-written kernel tied with it end to end
        # (PERF.md Findings).
        def hv(V: Array) -> Array:
            phi = self._proj(b, first, V)  # (rows, k)
            dense = hp.omega * (phi @ QTQ)
            # two calls, not ops.pos_hv: binding one gather to two consumers
            # makes XLA materialize it instead of fusing it into each
            # reduction
            pq = pos_dot(phi, own, Q1, other) * w_pos
            zp = pos_scatter((1.0 - hp.omega) * pq, Q1, other, own, num,
                             seg_sorted=first)
            return hp.lam * reg[:, None] * V + self._scat(b, first, dense + zp, dim)

        return hv

    # -- Jacobi preconditioner ------------------------------------------------

    def _scat_sq(self, b: BlockInfo, first: bool, Z: Array, dim: int) -> Array:
        """(X_side^2)^T @ Z — the squared-feature scatter the Hessian
        diagonal needs.  Identity fields: X^2 == X, reuse the slice path."""
        ident, _, _ = self._side_ident(b, first)
        if ident and dim <= Z.shape[0]:
            return self._scat(b, first, Z, dim)
        i1, v1, _, _ = self._side_arrays(b, first)
        return scatter(i1, v1 * v1, Z, dim)

    def _diag_H(self, state, b: BlockInfo, first: bool, posq=None):
        """Exact diagonal of the block-table Hessian (oracle: diag_hessian):

          cross:  D[d,l] = lam reg[d] + sum_ij Wq_ij X1[i,d]^2 Q1[j,l]^2
                         = lam reg + X1s^T [ w diag(Q1^T Q1)
                                             + (1-w) pos-scatter of Q1^2 ]
          self :  D[d,l] = lam reg[d] + X1s^T (dd_i Q1[i,l]^2)

        ``posq``: the cross positive term precomputed by the gradient's
        fused pass (_grad_cross with_diag_pos) — the diag then costs no COO
        pass of its own."""
        meta, d = self.meta, self.data
        hp = meta.hp
        if self.cg_precond != "jacobi":
            return None
        i1, v1, reg, rows = self._side_arrays(b, first)
        Q1 = state["Q"][b.f12] if first else state["P"][b.f12]
        dim = (state["params"][b.f12]["W" if first else "H"]).shape[0]
        if b.kind == "uv":
            own = d["pos_u"] if first else d["pos_v"]
            other = d["pos_v"] if first else d["pos_u"]
            num = meta.m if first else meta.n
            qtq_d = jnp.sum(Q1 * Q1, axis=0)  # pad rows are zero
            if posq is None:
                posq = pos_scatter(
                    (1.0 - hp.omega) * d["pos_w"], Q1 * Q1, other, own, num,
                    seg_sorted=first,
                )
            rowq = hp.omega * qtq_d[None, :] + posq
        else:
            if b.kind == "uu":
                dd = (1.0 - hp.omega) * d["cnt_u"] + hp.omega * meta.n_true
            else:
                dd = (1.0 - hp.omega) * d["cnt_v"] + hp.omega * meta.m_true
            rowq = dd[:, None] * (Q1 * Q1)
        D = hp.lam * reg[:, None] + self._scat_sq(b, first, rowq, dim)
        # pad table rows have D == 0 and R == 0; clamp so R/D stays 0 not NaN
        return jnp.maximum(D, jnp.asarray(1e-12, D.dtype))

    # -- conjugate gradient ---------------------------------------------------

    def _cg(self, hv, G: Array, D: Array | None = None) -> Array:
        """Newton-step CG (cg, ffm.cpp:744-813): S = argmin quadratic; stop
        when ||r||^2 <= cg_eps ||g||^2 or after cg_max_iter iterations.

        With ``D``: Jacobi-preconditioned CG on the same system with the
        same TRUE-residual stop rule — only the search directions change
        (measured ~1.6x fewer iterations, and capped solves land closer to
        the exact Newton step).  Mirrored exactly by the fp64 oracle.

        Mixed precision: the CG recurrence (S/R/V vectors, alpha/beta/r2
        scalars) runs at an f32 floor even under bf16 storage — bf16's
        8-bit mantissa stalls the residual recurrence so solves burn to the
        iteration cap instead of converging.  Only the Hv evaluation (the
        bandwidth-bound positive passes) stays in storage dtype.  No-op for
        f32/f64 problems."""
        hp = self.meta.hp
        # Hv evaluation runs at STORAGE dtype (the bandwidth-bound stream
        # passes); the recurrence — and the returned step S — stay at the
        # f32 floor.
        storage = self.meta.dtype
        ct = jnp.promote_types(G.dtype, jnp.float32)  # f32 floor, keeps f64
        Gc = G.astype(ct)
        Dc = None if D is None else D.astype(ct)
        g2 = jnp.sum(Gc * Gc)

        def cond(carry):
            S, R, V, r2, rz, it = carry
            return jnp.logical_and(r2 > hp.cg_eps * g2, it < hp.cg_max_iter)

        def body(carry):
            S, R, V, r2, rz, it = carry
            Hv = hv(V.astype(storage)).astype(ct)
            den = jnp.sum(V * Hv)
            # degenerate-denominator guard: on a (near-)converged block the
            # f32 recurrence can underflow V.Hv to exactly 0 (mathematically
            # it is >= lam * reg * |V|^2 > 0; the f64 reference never sees
            # this) — an unguarded rz/0 step writes inf/nan into the table
            # and poisons ploss forever after (found by the sweep-tier
            # parity run: 7/10 seeds NaN at k=16, lam=4, omega=2^-11, f32).
            # Take no step and force the stop condition instead.
            ok = den > 0
            alpha = jnp.where(ok, rz / jnp.where(ok, den, 1.0), 0.0)
            S = S + alpha * V
            R = R - alpha * Hv
            r2_new = jnp.where(ok, jnp.sum(R * R), 0.0)
            rz_safe = jnp.where(rz > 0, rz, 1.0)
            if Dc is None:
                rz_new = r2_new
                V = R + (rz_new / rz_safe) * V
            else:
                Z = R / Dc
                rz_new = jnp.sum(R * Z)
                V = Z + (rz_new / rz_safe) * V
            return S, R, V, r2_new, rz_new, it + 1

        S0 = jnp.zeros_like(Gc)
        V0 = -Gc if Dc is None else -Gc / Dc
        rz0 = g2 if Dc is None else jnp.sum(Gc * (Gc / Dc))
        init = (S0, -Gc, V0, g2, rz0, jnp.asarray(0, jnp.int32))
        S, _, _, _, _, it = jax.lax.while_loop(cond, body, init)
        # S returns at the f32 floor: the caller applies it to the table in
        # ONE rounding ((T + S).astype(storage)) instead of rounding S and
        # the sum separately (the bf16 divergence incident, PARITY.md)
        return S, it

    # -- block updates (incremental cache refresh) ----------------------------

    def _apply_step(self, state, b: BlockInfo, first: bool, S: Array,
                    rows_pre=None, rows_hd=None):
        """Apply the Newton step and refresh P/Q, a/b, yt functionally
        (update_side ffm.cpp:405-437, update_cross ffm.cpp:439-465).

        ``rows_pre``: the solve's pre-gathered B-row stream
        (gather_blocked_rows).  B (= the OTHER side's cache) is untouched by
        this step — only the own-side table/cache move — so the gap pass can
        reuse it and run fully blocked (ops.pos_gap_blocked)."""
        d = self.data
        f12 = b.f12
        key = "W" if first else "H"
        i1, v1, _, _ = self._side_arrays(b, first)
        state = dict(state)
        params = dict(state["params"])
        blk_params = dict(params[f12])
        # S arrives at the CG f32 floor: sum in f32, round ONCE into the
        # stored table (no-op at f32/f64)
        blk_params[key] = (blk_params[key] + S).astype(self.meta.dtype)
        params[f12] = blk_params
        state["params"] = params

        # cache/residual increments run at storage dtype (the incremental
        # bookkeeping path; refresh_every bounds its drift)
        S = S.astype(self.meta.dtype)
        dP = self._proj(b, first, S)
        cache_key = "P" if first else "Q"
        caches = dict(state[cache_key])
        caches[f12] = caches[f12] + dP
        state[cache_key] = caches

        other = state["Q"][f12] if first else state["P"][f12]
        meta = self.meta
        sharded = meta.blocked_shards > 1
        if b.kind == "uu":
            da = jnp.sum(dP * other, axis=1)
            state["a"] = state["a"] + da
            if self.blk_yt:
                # own side: da expands per block (sequential); other side:
                # blk_v_take IS pos_u in v-slot order — one scalar gather
                # (under the mesh that gather crosses shards; GSPMD turns
                # it into the carry-propagation collective)
                exp = (self._expand_rows_sharded(True, da) if sharded
                       else expand_rows_blocked(
                           da, d["blk_u_own"], meta.blocked_bm_u))
                state["yt_u"] = state["yt_u"] + exp.reshape(
                    state["yt_u"].shape)
                state["yt_v"] = state["yt_v"] + da[d["blk_v_take"]] \
                    * d["blk_v_w"]
                # head tiers: da per slot is a broadcast on the own side
                # (chunk -> its row) and a scalar gather through hd_take
                # (= pos_u in head slot order) on the other side
                if self.hd_u:
                    state["yt_u_hd"] = state["yt_u_hd"] \
                        + da[d["blk_u_hd_row"]][:, None] * d["blk_u_hd_w"]
                if self.hd_v:
                    state["yt_v_hd"] = state["yt_v_hd"] \
                        + da[d["blk_v_hd_take"]] * d["blk_v_hd_w"]
            else:
                state["yt"] = state["yt"] + da[d["pos_u"]]
        elif b.kind == "vv":
            db = jnp.sum(dP * other, axis=1)
            state["b"] = state["b"] + db
            if self.blk_yt:
                exp = (self._expand_rows_sharded(False, db) if sharded
                       else expand_rows_blocked(
                           db, d["blk_v_own"], meta.blocked_bm_v))
                state["yt_v"] = state["yt_v"] + exp.reshape(
                    state["yt_v"].shape)
                state["yt_u"] = state["yt_u"] + db[d["blk_u_take"]] \
                    * d["blk_u_w"]
                if self.hd_v:
                    state["yt_v_hd"] = state["yt_v_hd"] \
                        + db[d["blk_v_hd_row"]][:, None] * d["blk_v_hd_w"]
                if self.hd_u:
                    state["yt_u_hd"] = state["yt_u_hd"] \
                        + db[d["blk_u_hd_take"]] * d["blk_u_hd_w"]
            else:
                state["yt"] = state["yt"] + db[d["pos_v"]]
        else:
            if self.blk_yt:
                # gap lands directly in the solving side's slot order (no
                # inverse permute); the other side's carry takes it through
                # the static cross-order map — the only scalar gather left
                pre = "blk_u_" if first else "blk_v_"
                bm = meta.blocked_bm_u if first else meta.blocked_bm_v
                if sharded:
                    gap_flat = self._gap_blocked_sharded(first, dP, rows_pre)
                else:
                    gap_flat = pos_gap_blocked(dP, rows_pre, d[pre + "own"],
                                               None, bm)
                gap_hd = None
                if rows_hd is not None:
                    # head gap in head slot order; the cross-order maps
                    # index the CONCATENATED (tail, head) flat space
                    gap_hd = head_pq(dP[d[pre + "hd_row"]], rows_hd)
                gap_cat = (jnp.concatenate([gap_flat, gap_hd.reshape(-1)])
                           if gap_hd is not None else gap_flat)
                if first:
                    state["yt_u"] = state["yt_u"] + gap_flat.reshape(
                        state["yt_u"].shape) * d["blk_u_w"]
                    if gap_hd is not None:
                        state["yt_u_hd"] = state["yt_u_hd"] \
                            + gap_hd * d["blk_u_hd_w"]
                    state["yt_v"] = state["yt_v"] \
                        + gap_cat[d["blk_v_from_u"]] * d["blk_v_w"]
                    if self.hd_v:
                        state["yt_v_hd"] = state["yt_v_hd"] \
                            + gap_cat[d["blk_v_hd_from_u"]] \
                            * d["blk_v_hd_w"]
                else:
                    state["yt_v"] = state["yt_v"] + gap_flat.reshape(
                        state["yt_v"].shape) * d["blk_v_w"]
                    if gap_hd is not None:
                        state["yt_v_hd"] = state["yt_v_hd"] \
                            + gap_hd * d["blk_v_hd_w"]
                    state["yt_u"] = state["yt_u"] \
                        + gap_cat[d["blk_u_from_v"]] * d["blk_u_w"]
                    if self.hd_u:
                        state["yt_u_hd"] = state["yt_u_hd"] \
                            + gap_cat[d["blk_u_hd_from_v"]] \
                            * d["blk_u_hd_w"]
                return state
            if rows_pre is not None and self.blk_gap:
                pre = "blk_u_" if first else "blk_v_"
                bm = meta.blocked_bm_u if first else meta.blocked_bm_v
                flatg = pos_gap_blocked(dP, rows_pre, d[pre + "own"], None,
                                        bm)
                if rows_hd is not None:
                    # inv maps two-tier sides into the concatenated space
                    flatg = jnp.concatenate([
                        flatg,
                        head_pq(dP[d[pre + "hd_row"]],
                                rows_hd).reshape(-1)])
                gap = flatg[d[pre + "inv"]]
            else:
                own_ids = d["pos_u"] if first else d["pos_v"]
                oth_ids = d["pos_v"] if first else d["pos_u"]
                gap = pos_dot(dP, own_ids, other, oth_ids)
            state["yt"] = state["yt"] + gap * d["pos_w"]
        return state

    # -- per-block solve ------------------------------------------------------

    def _solve_inputs(self, state, b: BlockInfo, first: bool, sa, sb):
        """(G, hv, D, rows_pre, rows_hd) of one half-solve: the gradient,
        the Hessian-vector closure, the Jacobi diagonal (or None) and the
        pre-gathered streams the update pass reuses."""
        jac = self.cg_precond == "jacobi"
        posq = None
        rows_pre = rows_hd = None
        if b.kind == "uv":
            # B (= Q1) is constant for the whole solve: pre-gather its
            # blocked stream once; the gradient and every CG iteration then
            # stream it sequentially instead of re-gathering randomly.
            d = self.data
            B1 = state["Q"][b.f12] if first else state["P"][b.f12]
            if self._hd_side(first):
                # the head tier's stream is always pre-gathered (its slot
                # budget is bounded by the layout's cost guard)
                rows_hd = gather_blocked_rows(
                    B1, d["blk_u_hd_take" if first else "blk_v_hd_take"])
            if self.pregather_u if first else self.pregather_v:
                rows_pre = gather_blocked_rows(
                    B1, d["blk_u_take" if first else "blk_v_take"])
                if self.meta.blocked_shards > 1:
                    # the main collective of a sharded blocked solve: B is
                    # row-sharded, so this gather all-gathers it once per
                    # solve; pin the result to the block sharding the
                    # shard_map passes expect
                    from jax.sharding import NamedSharding
                    from jax.sharding import PartitionSpec as P

                    rows_pre = jax.lax.with_sharding_constraint(
                        rows_pre,
                        NamedSharding(self.mesh, P(self.data_axis,
                                                   None, None)))
            if jac:
                G, posq = self._grad_cross(state, b, first,
                                           with_diag_pos=True,
                                           rows_pre=rows_pre,
                                           rows_hd=rows_hd)
            else:
                G = self._grad_cross(state, b, first, rows_pre=rows_pre,
                                     rows_hd=rows_hd)
            hv = self._hv_cross(state, b, first, rows_pre=rows_pre,
                                rows_hd=rows_hd)
        else:
            G = self._grad_self(state, b, first, sa, sb)
            hv = self._hv_self(state, b, first)
        return G, hv, self._diag_H(state, b, first, posq), rows_pre, rows_hd

    def _solve_half(self, state, b: BlockInfo, first: bool, sa, sb):
        G, hv, D, rows_pre, rows_hd = self._solve_inputs(
            state, b, first, sa, sb)
        S, it = self._cg(hv, G, D)
        return self._apply_step(state, b, first, S, rows_pre=rows_pre,
                                rows_hd=rows_hd), it

    # -- epoch ----------------------------------------------------------------

    def _epoch_impl(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """One alternating sweep in reference order (one_epoch,
        ffm.cpp:852-870): user self blocks, item self blocks, cross blocks;
        within each block the f1 table then the f2 table (ffm.cpp:815-850).

        sa/sb are refreshed once per epoch (the reference refreshes at epoch
        end, ffm.cpp:869 — refreshing at epoch start is identical since only
        self-block gradients read them and cross updates happen after)."""
        sa, sb = self._cache_sasb(state["P"], state["Q"])
        iters = []
        for b in self.meta.layout.epoch_order():
            state, it1 = self._solve_half(state, b, True, sa, sb)
            state, it2 = self._solve_half(state, b, False, sa, sb)
            iters.extend((it1, it2))
        return state, jnp.stack(iters)

    def epoch(self, state: Dict[str, Any]) -> Dict[str, Any]:
        return self._epoch(state, self.data)[0]

    def epoch_stats(self, state):
        """(new_state, per-solve CG iteration counts) — one extra compiled
        program; the counts vector follows epoch_order() with the f1 then f2
        half of each block adjacent.  Diagnostics only (profiling, A/Bs)."""
        return self._epoch(state, self.data)

    # -- diagnostics ----------------------------------------------------------

    def grad_hv(self, state) -> Dict[str, Tuple[Array, Array]]:
        """{"<f12><W|H>": (G, Hv(G))} for every half-solve of an epoch, all
        at the given state: the gradient and Hessian-vector passes the CG
        solves run, without solving or updating.  One compiled program —
        for comparing layouts, devices and precisions on one state."""
        return self._grad_hv(state, self.data)

    def _grad_hv_impl(self, state):
        sa, sb = self._cache_sasb(state["P"], state["Q"])
        out = {}
        for b in self.meta.layout.epoch_order():
            for first in (True, False):
                G, hv, _, _, _ = self._solve_inputs(state, b, first, sa, sb)
                out[f"{b.f12}{'W' if first else 'H'}"] = (
                    G, hv(G.astype(self.meta.dtype)))
        return out

    def objective(self, state: Dict[str, Any]) -> Array:
        return self._objective(state, self.data)

    def _objective_impl(self, state: Dict[str, Any]) -> Array:
        """Exact loss via the rank-k decomposition (matches the reference's
        brute-force func(), ffm.cpp:1321-1351, without materializing m x n).

        sum_all w (yhat - r)^2 = w [ sum_ij (a_i + b_j + cross_ij - r)^2 ]
        expanded with Gram matrices; positives corrected via yt.
        """
        meta, d = self.meta, self.data
        hp = meta.hp
        P, Q, a, b_vec = state["P"], state["Q"], state["a"], state["b"]
        # slot-order carry: reconstruct the stream residual (pad-masked —
        # exact here, every yt term below is multiplied by w anyway)
        yt = state["yt"] if "yt" in state else self.yt_stream(state)
        m, n = meta.m_true, meta.n_true
        at = a[:m]
        bt = b_vec[:n]
        cross_blocks = meta.layout.cross_blocks()
        # sum over all pairs of yhat_ij and yhat_ij^2, using
        # yhat = (a_i - r/2) + (b_j - r/2) + sum_c <P_ci, Q_cj>  shifted by r:
        # compute E1 = sum (yhat - r), E2 = sum (yhat - r)^2.
        alpha = at - hp.r  # fold r into the user side
        sumP = {c.f12: jnp.sum(P[c.f12][:m], axis=0) for c in cross_blocks}
        sumQ = {c.f12: jnp.sum(Q[c.f12][:n], axis=0) for c in cross_blocks}
        # E2 = sum_i sum_j (alpha_i + b_j + s_ij)^2 where s_ij = sum_c <P,Q>
        #    = n sum alpha^2 + m sum b^2 + sum s^2 + 2 sum_i alpha_i sum_j b_j
        #      + 2 sum_ij (alpha_i + b_j) s_ij
        sum_alpha = jnp.sum(alpha)
        sum_b = jnp.sum(bt)
        e2 = n * jnp.sum(alpha**2) + m * jnp.sum(bt**2)
        e2 = e2 + 2.0 * sum_alpha * sum_b
        # sum_ij s_ij^2 = sum_{c,c'} <P_c^T P_c', Q_c^T Q_c'>: the (c, c')
        # block structure of the concatenated Grams covers every pair in two
        # (m, C*k) matmuls instead of C^2 k x k grams.
        Pcat = jnp.concatenate([P[c.f12][:m] for c in cross_blocks], axis=1)
        Qcat = jnp.concatenate([Q[c.f12][:n] for c in cross_blocks], axis=1)
        e2 = e2 + jnp.sum((Pcat.T @ Pcat) * (Qcat.T @ Qcat))
        # 2 sum_ij alpha_i s_ij + 2 sum_ij b_j s_ij
        for c in cross_blocks:
            e2 = e2 + 2.0 * (alpha @ (P[c.f12][:m] @ sumQ[c.f12]))
            e2 = e2 + 2.0 * (bt @ (Q[c.f12][:n] @ sumP[c.f12]))
        # positives: replace w (yhat - r)^2 by (yhat - 1)^2
        w = d["pos_w"]
        y_minus_r = yt + (1.0 - hp.r)
        loss = hp.omega * (e2 - jnp.sum(w * y_minus_r**2)) + jnp.sum(w * yt**2)
        for b in self.blocks:
            _, _, reg1, _ = self._side_arrays(b, True)
            _, _, reg2, _ = self._side_arrays(b, False)
            loss = loss + hp.lam * jnp.sum(
                reg1[:, None] * state["params"][b.f12]["W"] ** 2
            )
            loss = loss + hp.lam * jnp.sum(
                reg2[:, None] * state["params"][b.f12]["H"] ** 2
            )
        return 0.5 * loss
