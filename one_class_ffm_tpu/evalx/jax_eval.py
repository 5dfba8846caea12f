"""Full-catalog ranking evaluation on the device.

Re-designs the reference ``init_va``/``validate``/``prec_k``/``ndcg`` path
(reference ffm.cpp:872-1128) as batched XLA computations:

  * per-user score vector z = bt + sum_cross Pva_i . Qva_j over the full item
    catalog (pred_z, ffm.cpp:915-923), as one (chunk, n) matmul per cross
    block — one matmul per chunk instead of per-user dgemv.
  * cold-start users (no features) fall back to the popularity prior
    (ffm.cpp:975-977).
  * repeated destructive argmax (ffm.cpp:1033-1037) becomes
    ``jax.lax.top_k`` — identical tie-breaking (lowest index first).
  * metric semantics preserved exactly: cumulative K ladder {5,10,20,40,80},
    P@K = hits / (mt * K) over ALL test users, nDCG with binary gain and
    IDCG = min(#labels, K) terms, ploss over positives only with the user
    self-term at (ffm.cpp:1004-1015).
  * AUC added (new capability; the reference computes no AUC).

Everything here is pure; the chunk loop is a host loop over jitted chunks so
arbitrary test-set sizes work with a single compiled kernel shape.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import platform
from ..data.dataset import PaddedFields
from ..models.blocks import BlockLayout
from .numpy_metrics import TOP_K_LADDER

Array = jax.Array


@dataclass(frozen=True)
class EvalMeta:
    layout: BlockLayout
    mt: int  # padded test user rows
    mt_true: int
    n: int  # item rows (padded)
    n_true: int
    catalog: int  # rankable item ids: min(train label dim, n_true)
    pop_len: int  # popularity vector length (= train label dim)
    max_labels: int  # label matrix width
    top_ks: Tuple[int, ...] = TOP_K_LADDER
    dtype: Any = jnp.float32


def make_eval_data(
    uva: PaddedFields,
    va_labels: List[np.ndarray],
    popular: np.ndarray,
    n_items: int,
    n_items_true: int,
    layout: BlockLayout,
    dtype=jnp.float32,
    top_ks: Sequence[int] = TOP_K_LADDER,
) -> Tuple[EvalMeta, Dict[str, Any]]:
    """Assemble device arrays for evaluation.

    ``va_labels``: per true test user, array of positive item ids (may exceed
    the catalog; such ids count toward IDCG but can never be hit).
    ``popular``: the training popularity prior (length = train label dim).
    """
    mt_true = len(va_labels)
    mt = uva.m
    catalog = int(min(len(popular), n_items_true))
    max_l = max(1, max((len(l) for l in va_labels), default=1))
    labels = np.full((mt, max_l), -1, dtype=np.int32)
    n_labels = np.zeros(mt, dtype=np.int32)
    for i, l in enumerate(va_labels):
        labels[i, : len(l)] = np.asarray(l, dtype=np.int32)
        n_labels[i] = len(l)
    pop = np.zeros(n_items, dtype=np.float64)
    # popular may be longer than the item rows (train labels referencing
    # items absent from the item file — the reference reads out of bounds
    # there, ffm.cpp:1031; we truncate)
    npop = min(len(popular), n_items)
    pop[:npop] = popular[:npop]
    meta = EvalMeta(
        layout=layout,
        mt=mt,
        mt_true=mt_true,
        n=n_items,
        n_true=n_items_true,
        catalog=catalog,
        pop_len=len(popular),
        max_labels=max_l,
        top_ks=tuple(int(k) for k in top_ks),
        dtype=dtype,
    )
    data = dict(
        xva_idx=tuple(jnp.asarray(a) for a in uva.idx),
        xva_val=tuple(jnp.asarray(a, dtype) for a in uva.val),
        labels=jnp.asarray(labels),
        n_labels=jnp.asarray(n_labels),
        cold=jnp.asarray(uva.row_nnz == 0),
        valid=jnp.asarray(
            (np.arange(mt) < mt_true).astype(np.float64), dtype
        ),
        popular=jnp.asarray(pop, dtype),
    )
    return meta, data


class Evaluator:
    """Bound to one (test set, item side) pair; call ``validate(params, Q, bt)``.

    ``Q`` are the item-side cross-block projections and ``bt`` the item self
    sums from the *current* training state — items share features between
    train and eval so Qva == Q (the reference recomputes them from the same
    X_v, validate ffm.cpp:932-946).
    """

    def __init__(self, meta: EvalMeta, data: Dict[str, Any], chunk: int = 512,
                 item_mesh=None, item_axis: str = "data"):
        self.meta = meta
        self.data = data
        self.chunk = int(min(chunk, meta.mt))
        # pad test rows to a multiple of the chunk for a single kernel shape
        self._n_chunks = -(-meta.mt // self.chunk)
        self._item_mesh = item_mesh
        self._item_axis = item_axis
        if item_mesh is not None:
            self._chunk_fn = self._build_item_sharded_chunk()
        else:
            self._chunk_fn = jax.jit(self._eval_chunk)

    def shard(self, mesh, axis: str = "data") -> "Evaluator":
        """Data-parallel evaluation: test-user rows sharded over the mesh.

        Each device scores its user shard against the (replicated) item
        side; per-chunk metric sums are psum'd by GSPMD.  Use a chunk size
        divisible by the mesh size so chunk slices align with shards.
        """
        from jax.sharding import NamedSharding, PartitionSpec as P

        row = NamedSharding(mesh, P(axis))
        rep = NamedSharding(mesh, P())
        d = dict(self.data)
        d["xva_idx"] = tuple(jax.device_put(a, row) for a in d["xva_idx"])
        d["xva_val"] = tuple(jax.device_put(a, row) for a in d["xva_val"])
        for key in ("labels", "n_labels", "cold", "valid"):
            d[key] = jax.device_put(d[key], row)
        d["popular"] = jax.device_put(d["popular"], rep)
        return Evaluator(self.meta, d, chunk=self.chunk)

    def shard_items(self, mesh, axis: str = "data") -> "Evaluator":
        """Catalog-axis-sharded evaluation — the sequence-parallel analog
        (SURVEY.md §5 long-context): every device scores its ITEM shard for
        the same user chunk, metric sums are psum'd, and the global top-K
        merges per-shard candidates (payload K*n_dev per user instead of n).
        This is what scales eval past the dense (chunk, n) cliff at n ~ 10M
        (reference pred_z scales per-user, ffm.cpp:915-923; the dense
        path cannot hold (chunk, n) at web-scale catalogs)."""
        size = int(mesh.shape[axis])
        if self.meta.n % size != 0:
            raise ValueError(
                f"item rows {self.meta.n} not divisible by mesh axis "
                f"'{axis}' size {size}; pad item rows to a device multiple"
            )
        return Evaluator(self.meta, self.data, chunk=self.chunk,
                         item_mesh=mesh, item_axis=axis)

    # -- item-sharded chunk (catalog scale-out) ------------------------------

    def _build_item_sharded_chunk(self):
        """shard_map'd twin of ``_eval_chunk``: items sharded over the mesh
        axis, identical metric semantics (ladder, IDCG, cold fallback, ploss
        guard, first-max tie-breaking) — pinned by tests against the dense
        path.  Contiguous item partitioning means candidate order after
        all_gather is global-id order, so top-K tie-breaking matches the
        reference's destructive argmax (ffm.cpp:1033-1037)."""
        from jax.sharding import PartitionSpec as P

        meta = self.meta
        mesh = self._item_mesh
        axis = self._item_axis
        nd = int(mesh.shape[axis])
        nk = len(meta.top_ks)
        kmax = min(max(meta.top_ks), meta.catalog)
        n_local = meta.n // nd
        f12s = sorted(b.f12 for b in meta.layout.cross_blocks())

        def impl(Pva_c, at_c, labels_c, n_labels_c, cold_c, valid_c,
                 Q_sh, bt_sh, pop_sh):
            shard = jax.lax.axis_index(axis)
            lo = shard * n_local
            c = at_c.shape[0]
            z = jnp.broadcast_to(bt_sh[None, :], (c, n_local)).astype(meta.dtype)
            for f12 in f12s:
                z = z + Pva_c[f12] @ Q_sh[f12].T
            z = jnp.where(cold_c[:, None], pop_sh[None, :], z)

            # ploss: each label is owned by exactly one shard; psum the sums
            lab = labels_c
            labc = jnp.clip(lab, 0, meta.n - 1)
            loc = labc - lo
            owned = (loc >= 0) & (loc < n_local)
            z_at = jnp.take_along_axis(z, jnp.clip(loc, 0, n_local - 1), axis=1)
            lab_ok = (lab >= 0) & jnp.where(
                cold_c[:, None], lab < meta.pop_len, lab < meta.n_true
            )
            diff = 1.0 - z_at - at_c[:, None]
            ploss = jax.lax.psum(
                jnp.sum(jnp.where(lab_ok & owned, diff * diff, 0.0)
                        * valid_c[:, None]),
                axis,
            )

            # global top-K: local top-K over the catalog slice, all_gather
            # merge; candidates concatenate in shard (= global id) order
            gid = lo + jnp.arange(n_local, dtype=jnp.int32)
            neg = jnp.asarray(jnp.finfo(meta.dtype).min, meta.dtype)
            zc = jnp.where((gid < meta.catalog)[None, :], z, neg)
            kk = min(kmax, n_local)
            lv, li = jax.lax.top_k(zc, kk)
            lgi = gid[li]
            av = jax.lax.all_gather(lv, axis, axis=1, tiled=True)
            ai = jax.lax.all_gather(lgi, axis, axis=1, tiled=True)
            _tv, pos = jax.lax.top_k(av, kmax)
            top_idx = jnp.take_along_axis(ai, pos, axis=1)

            hit = jnp.any(
                top_idx[:, :, None] == jnp.where(lab >= 0, lab, -2)[:, None, :],
                axis=2,
            ).astype(meta.dtype)
            gains = 1.0 / jnp.log2(jnp.arange(kmax, dtype=meta.dtype) + 2.0)
            ranks = jnp.arange(kmax, dtype=jnp.int32)
            hits_k, ndcg_k = [], []
            for K in meta.top_ks:
                kK = min(K, meta.catalog)
                msk = (ranks < kK).astype(meta.dtype)
                hits_k.append(jnp.sum(hit * msk[None, :] * valid_c[:, None]))
                dcg = jnp.sum(hit * (gains * msk)[None, :], axis=1)
                idcg = jnp.sum(
                    jnp.where(
                        ranks[None, :] < jnp.minimum(n_labels_c[:, None], kK),
                        gains[None, :], 0.0,
                    ),
                    axis=1,
                )
                nd_ = jnp.where(idcg > 0, dcg / jnp.maximum(idcg, 1e-30), 0.0)
                ndcg_k.append(jnp.sum(nd_ * valid_c))

            # AUC: psum'd below/tie counts against the sharded catalog
            pos_ok = (lab >= 0) & (lab < meta.catalog)
            locq = jnp.clip(lab, 0, meta.catalog - 1) - lo
            owned_q = (locq >= 0) & (locq < n_local)
            zq_own = jnp.where(
                owned_q,
                jnp.take_along_axis(z, jnp.clip(locq, 0, n_local - 1), axis=1),
                0.0,
            )
            z_pos = jax.lax.psum(zq_own, axis)
            srt = jnp.sort(
                jnp.where((gid < meta.catalog)[None, :], z, jnp.inf), axis=1
            )
            ss = jax.vmap(lambda s, q: jnp.searchsorted(s, q, side="left"))
            ssr = jax.vmap(lambda s, q: jnp.searchsorted(s, q, side="right"))
            lt = jax.lax.psum(ss(srt, z_pos).astype(meta.dtype), axis)
            rt = jax.lax.psum(ssr(srt, z_pos).astype(meta.dtype), axis)
            ties = rt - lt - 1.0  # minus self
            npos = jnp.sum(pos_ok, axis=1).astype(meta.dtype)
            zp_masked = jnp.where(pos_ok, z_pos, jnp.inf)
            srt_p = jnp.sort(zp_masked, axis=1)
            lt_pp = ss(srt_p, z_pos).astype(meta.dtype)
            rt_pp = ssr(srt_p, z_pos).astype(meta.dtype)
            tie_pp = rt_pp - lt_pp - 1.0
            per_pos = jnp.where(
                pos_ok, (lt - lt_pp) + 0.5 * (ties - tie_pp), 0.0
            )
            nneg = meta.catalog - npos
            denom = npos * nneg
            auc_u = jnp.where(
                denom > 0, jnp.sum(per_pos, axis=1) / jnp.maximum(denom, 1.0),
                0.5,
            )
            auc = jnp.sum(auc_u * valid_c)
            return jnp.stack(hits_k), jnp.stack(ndcg_k), ploss, auc

        sharded = jax.jit(
            jax.shard_map(
                impl,
                mesh=mesh,
                in_specs=(P(), P(), P(), P(), P(), P(),
                          P(axis, None), P(axis), P(axis)),
                out_specs=(P(), P(), P(), P()),
                check_vma=False,  # psum/all_gather outputs are replicated
            )
        )

        def chunk_fn(Pva_c, at_c, labels_c, n_labels_c, cold_c, valid_c, Q, bt):
            Qc = {f12: Q[f12] for f12 in f12s}  # cross blocks only (item side)
            return sharded(Pva_c, at_c, labels_c, n_labels_c, cold_c, valid_c,
                           Qc, bt, self.data["popular"])

        return chunk_fn

    # -- projections ---------------------------------------------------------

    def _project_users(self, params) -> Tuple[Dict[int, Array], Array]:
        """Pva per cross/user-self block + test user self sums at
        (init_va/validate, ffm.cpp:872-963)."""
        from ..solver.jax_solver import project

        meta, d = self.meta, self.data
        lay = meta.layout
        Pva: Dict[int, Array] = {}
        Qva_self: Dict[int, Array] = {}
        at = jnp.zeros(meta.mt, meta.dtype)
        for b in lay.user_self_blocks():
            P = project(d["xva_idx"][b.fi], d["xva_val"][b.fi], params[b.f12]["W"])
            Q = project(d["xva_idx"][b.fj], d["xva_val"][b.fj], params[b.f12]["H"])
            at = at + jnp.sum(P * Q, axis=1)
        for b in lay.cross_blocks():
            Pva[b.f12] = project(
                d["xva_idx"][b.fi], d["xva_val"][b.fi], params[b.f12]["W"]
            )
        return Pva, at

    # -- one chunk of users --------------------------------------------------

    def _eval_chunk(self, Pva_c, at_c, labels_c, n_labels_c, cold_c, valid_c, Q, bt):
        """Score + rank + metrics for one user chunk.  Returns per-chunk sums
        of (hits[nk], dcg_frac[nk], ploss, auc, count)."""
        meta, d = self.meta, self.data
        nk = len(meta.top_ks)
        kmax = min(max(meta.top_ks), meta.catalog)

        # scores over all items: z = bt + sum_c Pva_c Q_c^T  (warm users)
        z = jnp.broadcast_to(bt[None, :], (at_c.shape[0], meta.n)).astype(meta.dtype)
        for b in meta.layout.cross_blocks():
            z = z + Pva_c[b.f12] @ Q[b.f12].T
        # cold users: popularity prior replaces the model score entirely
        z = jnp.where(cold_c[:, None], d["popular"][None, :], z)

        # ploss over test positives: (1 - z_j - at_i)^2.  Guard j < len(z):
        # warm users score V->m items, cold users score the popularity vector
        # (reference ffm.cpp:982-986 with z.size() differing by branch).
        lab = labels_c  # (c, L)
        lab_ok = (lab >= 0) & jnp.where(
            cold_c[:, None], lab < meta.pop_len, lab < meta.n_true
        )
        z_at = jnp.take_along_axis(z, jnp.clip(lab, 0, meta.n - 1), axis=1)
        diff = 1.0 - z_at - at_c[:, None]
        ploss = jnp.sum(
            jnp.where(lab_ok, diff * diff, 0.0) * valid_c[:, None]
        )

        # rank the catalog slice
        zc = z[:, : meta.catalog]
        top_val, top_idx = jax.lax.top_k(zc, kmax)  # ties -> lowest index
        # hit[t] = top_idx[t] in label set
        hit = jnp.any(
            top_idx[:, :, None] == jnp.where(lab >= 0, lab, -2)[:, None, :], axis=2
        ).astype(meta.dtype)
        gains = 1.0 / jnp.log2(jnp.arange(kmax, dtype=meta.dtype) + 2.0)
        ranks = jnp.arange(kmax, dtype=jnp.int32)
        hits_k = []
        ndcg_k = []
        for K in meta.top_ks:
            kk = min(K, meta.catalog)
            msk = (ranks < kk).astype(meta.dtype)
            hits_k.append(jnp.sum(hit * msk[None, :] * valid_c[:, None]))
            dcg = jnp.sum(hit * (gains * msk)[None, :], axis=1)
            idcg = jnp.sum(
                jnp.where(
                    ranks[None, :] < jnp.minimum(n_labels_c[:, None], kk), gains[None, :], 0.0
                ),
                axis=1,
            )
            nd = jnp.where(idcg > 0, dcg / jnp.maximum(idcg, 1e-30), 0.0)
            ndcg_k.append(jnp.sum(nd * valid_c))

        # AUC: positives inside the catalog vs all other catalog items
        srt = jnp.sort(zc, axis=1)
        pos_ok = (lab >= 0) & (lab < meta.catalog)
        z_pos = jnp.take_along_axis(zc, jnp.clip(lab, 0, meta.catalog - 1), axis=1)
        lt = jax.vmap(lambda s, q: jnp.searchsorted(s, q, side="left"))(srt, z_pos)
        rt = jax.vmap(lambda s, q: jnp.searchsorted(s, q, side="right"))(srt, z_pos)
        lt = lt.astype(meta.dtype)
        ties = (rt - lt).astype(meta.dtype) - 1.0  # minus self
        npos = jnp.sum(pos_ok, axis=1).astype(meta.dtype)
        # among-positive comparisons to subtract — O(L log L) via a sorted
        # copy with invalid slots pushed to +inf (never below a finite query)
        zp_masked = jnp.where(pos_ok, z_pos, jnp.inf)
        srt_p = jnp.sort(zp_masked, axis=1)
        lt_pp = jax.vmap(lambda s, q: jnp.searchsorted(s, q, side="left"))(
            srt_p, z_pos
        ).astype(meta.dtype)
        rt_pp = jax.vmap(lambda s, q: jnp.searchsorted(s, q, side="right"))(
            srt_p, z_pos
        ).astype(meta.dtype)
        tie_pp = rt_pp - lt_pp - 1.0  # ties among positives minus self
        per_pos = jnp.where(pos_ok, (lt - lt_pp) + 0.5 * (ties - tie_pp), 0.0)
        nneg = meta.catalog - npos
        denom = npos * nneg
        auc_u = jnp.where(denom > 0, jnp.sum(per_pos, axis=1) / jnp.maximum(denom, 1.0), 0.5)
        auc = jnp.sum(auc_u * valid_c)

        return jnp.stack(hits_k), jnp.stack(ndcg_k), ploss, auc

    # -- public entry ---------------------------------------------------------

    def validate(self, params, Q, bt) -> Dict[str, float]:
        """Full evaluation pass; returns the reference's metric dict
        (fractions, not x100) plus AUC."""
        with platform.precision_scope(self.meta.dtype):
            return self._validate(params, Q, bt)

    def _validate(self, params, Q, bt) -> Dict[str, float]:
        meta, d = self.meta, self.data
        Pva, at = self._project_users(params)
        nk = len(meta.top_ks)
        hits = np.zeros(nk)
        ndcgs = np.zeros(nk)
        ploss = 0.0
        auc = 0.0
        c = self.chunk
        for s in range(self._n_chunks):
            lo = s * c
            sl = slice(lo, lo + c)

            def pad(x):
                if x.shape[0] >= lo + c:
                    return x[sl]
                padw = [(0, lo + c - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
                return jnp.pad(x[lo:], padw)

            Pva_c = {f12: pad(P) for f12, P in Pva.items()}
            h, nd, pl, au = self._chunk_fn(
                Pva_c,
                pad(at),
                pad(d["labels"]),
                pad(d["n_labels"]),
                pad(d["cold"]),
                pad(d["valid"]),
                Q,
                bt,
            )
            hits += np.asarray(h)
            ndcgs += np.asarray(nd)
            ploss += float(pl)
            auc += float(au)
        mt = meta.mt_true
        out: Dict[str, float] = {}
        for s_i, K in enumerate(meta.top_ks):
            out[f"p@{K}"] = hits[s_i] / (mt * K)
            out[f"ndcg@{K}"] = ndcgs[s_i] / mt
        out["ploss"] = float(np.sqrt(ploss / mt))
        out["auc"] = auc / mt
        return out
