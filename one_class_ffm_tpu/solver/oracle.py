"""Brute-force numpy oracle for the one-class FFM objective and solver.

Everything here is O(m*n*k) dense float64 math derived directly from the loss

    L = 1/2 [ sum_{(i,j) in POS} (yhat_ij - 1)^2
            + omega * sum_{(i,j) not in POS} (yhat_ij - r)^2
            + sum_blocks lambda * ||.||^2_(freq) ]

    yhat_ij = a_i + b_j + sum_{cross blocks} <P_i, Q_j>

(the exact form the reference's debug ``func()`` brute-forces,
ffm.cpp:1321-1351).  It exists to *gate* the fast device path: the JAX solver
must match this oracle block-for-block on tiny data.

``oracle_epoch`` runs the same alternating Gauss-Newton sweep as the fast
path (same block order, same CG iteration, same stopping rule,
ffm.cpp:744-870) but with gradients/Hessian-vector products computed from the
dense residual matrix, so agreement is a strong end-to-end check of the
rank-k algebra (sa/sb caches, k x k Grams, incremental residuals).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from ..models.blocks import BlockInfo, BlockLayout
from .params import HyperParams

Arr = np.ndarray


@dataclass
class OracleProblem:
    layout: BlockLayout
    hp: HyperParams
    Xu: List[Arr]  # per user field: dense (m, Du[fi]) float64
    Xv: List[Arr]  # per item field: dense (n, Dv[fi])
    pos: Arr  # (m, n) bool — positive pairs
    freq_u: Optional[List[Arr]] = None  # per field feature counts (for --freq)
    freq_v: Optional[List[Arr]] = None

    @property
    def m(self) -> int:
        return self.Xu[0].shape[0]

    @property
    def n(self) -> int:
        return self.Xv[0].shape[0]

    def side_X(self, b: BlockInfo, first: bool) -> Arr:
        """Dense feature matrix for the block's f1 (first=True) or f2 side."""
        fg = b.f1 if first else b.f2
        fl = b.fi if first else b.fj
        return self.Xu[fl] if fg < self.layout.fu else self.Xv[fl]

    def side_freq(self, b: BlockInfo, first: bool) -> Arr:
        fg = b.f1 if first else b.f2
        fl = b.fi if first else b.fj
        fr = self.freq_u if fg < self.layout.fu else self.freq_v
        assert fr is not None
        return fr[fl]


def projections(prob: OracleProblem, params: Dict[str, Dict[int, Arr]]):
    """P[f12] = X_{f1} W[f12], Q[f12] = X_{f2} H[f12] for active blocks."""
    P, Q = {}, {}
    for b in prob.layout.all_blocks():
        P[b.f12] = prob.side_X(b, True) @ params["W"][b.f12]
        Q[b.f12] = prob.side_X(b, False) @ params["H"][b.f12]
    return P, Q


def predict_dense(prob: OracleProblem, params) -> Arr:
    """Full (m, n) score matrix yhat = a_i + b_j + cross(i, j)."""
    P, Q = projections(prob, params)
    lay = prob.layout
    a = np.zeros(prob.m)
    b_vec = np.zeros(prob.n)
    yh = np.zeros((prob.m, prob.n))
    for b in lay.user_self_blocks():
        a += np.einsum("ik,ik->i", P[b.f12], Q[b.f12])
    for b in lay.item_self_blocks():
        b_vec += np.einsum("ik,ik->i", P[b.f12], Q[b.f12])
    for b in lay.cross_blocks():
        yh += P[b.f12] @ Q[b.f12].T
    return yh + a[:, None] + b_vec[None, :]


def _reg_weights(prob: OracleProblem, b: BlockInfo, first: bool) -> Arr:
    """Per-row lambda multiplier: freq counts under --freq, else ones."""
    d = b.d1 if first else b.d2
    if prob.hp.freq:
        return prob.side_freq(b, first).astype(np.float64)
    return np.ones(d)


def objective(prob: OracleProblem, params) -> float:
    """Exact loss (reference func(), ffm.cpp:1321-1351; freq-lambda variant
    regularizes each table row by lambda * freq[row])."""
    hp = prob.hp
    yh = predict_dense(prob, params)
    pos = prob.pos
    res = float(((1.0 - yh[pos]) ** 2).sum())
    res += hp.omega * float(((hp.r - yh[~pos]) ** 2).sum())
    for b in prob.layout.all_blocks():
        rw1 = _reg_weights(prob, b, True)
        rw2 = _reg_weights(prob, b, False)
        res += hp.lam * float((rw1[:, None] * params["W"][b.f12] ** 2).sum())
        res += hp.lam * float((rw2[:, None] * params["H"][b.f12] ** 2).sum())
    return 0.5 * res


def _C_matrix(prob: OracleProblem, yh: Arr) -> Arr:
    """dL/dyhat: (yhat - 1) on positives, omega*(yhat - r) elsewhere."""
    hp = prob.hp
    return np.where(prob.pos, yh - 1.0, hp.omega * (yh - hp.r))


def _W_matrix(prob: OracleProblem) -> Arr:
    """Per-pair quadratic weight: 1 on positives, omega elsewhere."""
    return np.where(prob.pos, 1.0, prob.hp.omega)


def _cg(grad_fn_hv, G: Arr, hp: HyperParams, D: Optional[Arr] = None) -> Arr:
    """Reference CG loop (ffm.cpp:744-813): S=0, R=-G, V=R; fixed relative
    tolerance and iteration cap; returns the Newton step S.

    With ``D`` (Jacobi preconditioner, hp.cg_precond == "jacobi"): standard
    PCG on the SAME linear system with the SAME stop rule (true residual
    against ||g||^2) — only the Krylov directions change, cutting iteration
    counts ~1.6x and landing capped solves closer to the true Newton step."""
    S = np.zeros_like(G)
    R = -G
    g2 = float((G * G).sum())
    r2 = g2
    if D is None:
        V = R.copy()
        rz = r2
    else:
        Z = R / D
        V = Z.copy()
        rz = float((R * Z).sum())
    it = 0
    while r2 > hp.cg_eps * g2 and it < hp.cg_max_iter:
        it += 1
        Hv = grad_fn_hv(V)
        alpha = rz / float((V * Hv).sum())
        S += alpha * V
        R -= alpha * Hv
        r2 = float((R * R).sum())
        if D is None:
            rz_new = r2
            V = R + (rz_new / rz) * V
        else:
            Z = R / D
            rz_new = float((R * Z).sum())
            V = Z + (rz_new / rz) * V
        rz = rz_new
    return S


def diag_hessian(prob: OracleProblem, params, b: BlockInfo,
                 first_side: bool) -> Arr:
    """Exact diagonal of the block-table Hessian, brute-force from dense
    matrices (the quadratic model behind grad_and_hv):

      cross:  D[d,l] = lam rw[d] + sum_ij Wq_ij X1[i,d]^2 Q1[j,l]^2
      self :  D[d,l] = lam rw[d] + sum_i  dd_i  X1[i,d]^2 Q1[i,l]^2
    """
    hp = prob.hp
    X1 = prob.side_X(b, first_side)
    rw = _reg_weights(prob, b, first_side)
    Wq = _W_matrix(prob)
    if b.kind in ("uu", "vv"):
        other = params["H"][b.f12] if first_side else params["W"][b.f12]
        Q1 = prob.side_X(b, not first_side) @ other
        dd = Wq.sum(axis=1) if b.kind == "uu" else Wq.sum(axis=0)
        D = hp.lam * rw[:, None] + (X1**2).T @ (dd[:, None] * Q1**2)
    else:
        if first_side:
            Q1 = prob.side_X(b, False) @ params["H"][b.f12]  # (n, k)
            D = hp.lam * rw[:, None] + (X1**2).T @ (Wq @ Q1**2)
        else:
            P1 = prob.side_X(b, True) @ params["W"][b.f12]  # (m, k)
            D = hp.lam * rw[:, None] + (X1**2).T @ (Wq.T @ P1**2)
    return np.maximum(D, 1e-300)


def grad_and_hv(prob: OracleProblem, params, b: BlockInfo, first_side: bool):
    """Gradient G and Hessian-vector closure for one table of one block,
    derived brute-force from the dense residual matrix."""
    hp = prob.hp
    yh = predict_dense(prob, params)
    C = _C_matrix(prob, yh)
    Wq = _W_matrix(prob)

    X1 = prob.side_X(b, first_side)
    tbl = params["W"][b.f12] if first_side else params["H"][b.f12]
    rw = _reg_weights(prob, b, first_side)

    if b.kind in ("uu", "vv"):
        # Self block: both sides index the same rows.  Q1 is the *other*
        # table's projection.
        other = params["H"][b.f12] if first_side else params["W"][b.f12]
        Xo = prob.side_X(b, not first_side)
        Q1 = Xo @ other
        if b.kind == "uu":
            z = C.sum(axis=1)  # (m,)
            d = Wq.sum(axis=1)
        else:
            z = C.sum(axis=0)  # rows of this block are items
            d = Wq.sum(axis=0)
        G = hp.lam * rw[:, None] * tbl + X1.T @ (z[:, None] * Q1)

        def hv(Vm):
            phi = X1 @ Vm
            s = d * np.einsum("ik,ik->i", Q1, phi)
            return hp.lam * rw[:, None] * Vm + X1.T @ (s[:, None] * Q1)

    else:
        # Cross block.
        if first_side:
            Q1 = prob.side_X(b, False) @ params["H"][b.f12]  # (n, k)
            G = hp.lam * rw[:, None] * tbl + X1.T @ (C @ Q1)

            def hv(Vm):
                phi = X1 @ Vm  # (m, k)
                t = (Wq * (phi @ Q1.T)) @ Q1  # (m, k)
                return hp.lam * rw[:, None] * Vm + X1.T @ t

        else:
            P1 = prob.side_X(b, True) @ params["W"][b.f12]  # (m, k)
            G = hp.lam * rw[:, None] * tbl + X1.T @ (C.T @ P1)

            def hv(Vm):
                phi = X1 @ Vm  # (n, k)
                t = (Wq.T * (phi @ P1.T)) @ P1  # (n, k)
                return hp.lam * rw[:, None] * Vm + X1.T @ t

    return G, hv


def solve_block_half(
    prob: OracleProblem, params, b: BlockInfo, first_side: bool
) -> Arr:
    """One Gauss-Newton half-step: gradient + CG for the W (first_side) or H
    table of block ``b``, against the *current* params.  Returns the step S
    (does not apply it)."""
    G, hv = grad_and_hv(prob, params, b, first_side)
    # "auto" resolves to PLAIN CG (round 5 — mirrors the solver rule; the
    # sweep tier measured jacobi distorting converged-state quality)
    D = (diag_hessian(prob, params, b, first_side)
         if prob.hp.cg_precond == "jacobi" else None)
    return _cg(hv, G, prob.hp, D)


def oracle_epoch(prob: OracleProblem, params) -> Dict[str, Dict[int, Arr]]:
    """One full alternating sweep in reference order (ffm.cpp:852-870):
    user self blocks, item self blocks, cross blocks; within each block the
    f1-side table then the f2-side table (ffm.cpp:815-850)."""
    params = {
        "W": {k: v.copy() for k, v in params["W"].items()},
        "H": {k: v.copy() for k, v in params["H"].items()},
    }
    for b in prob.layout.epoch_order():
        S = solve_block_half(prob, params, b, True)
        params["W"][b.f12] = params["W"][b.f12] + S
        S = solve_block_half(prob, params, b, False)
        params["H"][b.f12] = params["H"][b.f12] + S
    return params


# ---------------------------------------------------------------------------
# Random tiny problems and their device form
# ---------------------------------------------------------------------------


def random_sparse_dense(rng, m, d, max_nnz, binary_vals=False):
    """Dense (m, d) matrix where each row has 1..max_nnz nonzeros."""
    X = np.zeros((m, d))
    for i in range(m):
        nnz = rng.integers(1, max_nnz + 1)
        cols = rng.choice(d, size=min(nnz, d), replace=False)
        X[i, cols] = 1.0 if binary_vals else rng.uniform(0.5, 1.5, size=cols.size)
    return X


def make_problem(
    rng,
    m=13,
    n=9,
    Du=(7, 5),
    Dv=(6, 4),
    self_side=True,
    freq=False,
    omega=0.25,
    lam=0.05,
    r=-1.0,
    max_nnz=2,
    density=0.3,
    cg_precond="jacobi",
    k=3,
):
    """Random tiny OracleProblem + matching random params (the fixtures of
    the oracle comparisons: tests and the chip smoke check)."""
    Xu = [random_sparse_dense(rng, m, d, max_nnz) for d in Du]
    Xv = [random_sparse_dense(rng, n, d, max_nnz) for d in Dv]
    pos = rng.random((m, n)) < density
    # every user and item gets at least one positive to keep metrics sane
    for i in range(m):
        if not pos[i].any():
            pos[i, rng.integers(n)] = True
    layout = BlockLayout.make(Du, Dv, self_side)
    hp = HyperParams(k=k, lam=lam, omega=omega, r=r, freq=freq,
                     cg_precond=cg_precond)
    freq_u = [X.astype(bool).sum(axis=0).astype(np.float64) for X in Xu]
    freq_v = [X.astype(bool).sum(axis=0).astype(np.float64) for X in Xv]
    prob = OracleProblem(
        layout=layout, hp=hp, Xu=Xu, Xv=Xv, pos=pos, freq_u=freq_u, freq_v=freq_v
    )
    params = {"W": {}, "H": {}}
    for b in layout.all_blocks():
        params["W"][b.f12] = rng.normal(scale=0.1 / np.sqrt(hp.k),
                                        size=(b.d1, hp.k))
        params["H"][b.f12] = rng.normal(scale=0.1 / np.sqrt(hp.k),
                                        size=(b.d2, hp.k))
    return prob, params


def dense_to_padded(X, m_pad=None, dtype=np.float64):
    """Dense (m, d) -> padded (idx, val) arrays with per-row nonzeros."""
    m, d = X.shape
    m_pad = m if m_pad is None else m_pad
    nnz_rows = [np.nonzero(X[i])[0] for i in range(m)]
    p = max(1, max(len(r) for r in nnz_rows))
    idx = np.zeros((m_pad, p), dtype=np.int32)
    val = np.zeros((m_pad, p), dtype=dtype)
    for i, cols in enumerate(nnz_rows):
        idx[i, : len(cols)] = cols
        val[i, : len(cols)] = X[i, cols]
    return idx, val


def to_device_problem(prob, row_pad=0, dtype=np.float64, multiple=1,
                      d_multiple=1, blocked_bm=0, blocked_shards=1):
    """OracleProblem -> (meta, data) for FFMSolver at storage ``dtype``,
    optionally padding rows.

    ``multiple``: round padded row counts and nnz up to this multiple (for
    sharding tests on an N-device mesh).  ``blocked_shards`` > 1: build the
    labels SHARD-ALIGNED via the library pad_labels (shard_rows=) so the
    blocked layout can run under shard_map."""
    from ..data.dataset import PaddedFields, PaddedLabels
    from .jax_solver import make_device_data

    def up(x):
        return -(-x // multiple) * multiple

    m, n = prob.m, prob.n
    m_pad, n_pad = up(m + row_pad), up(n + row_pad)

    def side(Xs, freqs, mp):
        pads = [dense_to_padded(X, mp, dtype) for X in Xs]
        return PaddedFields(
            m=mp,
            m_true=Xs[0].shape[0],
            f=len(Xs),
            Ds=tuple(X.shape[1] for X in Xs),
            idx=tuple(p[0] for p in pads),
            val=tuple(p[1] for p in pads),
            freq=tuple(f.astype(dtype) for f in freqs),
            row_nnz=np.asarray(
                sum((X != 0).sum(axis=1) for X in Xs).tolist() + [0] * (mp - Xs[0].shape[0]),
                dtype=np.int32,
            ),
        )

    u = side(prob.Xu, prob.freq_u, m_pad)
    v = side(prob.Xv, prob.freq_v, n_pad)
    uu, vv = np.nonzero(prob.pos)
    nnz_true = uu.size
    if blocked_shards > 1:
        from ..data.dataset import Interactions, pad_labels

        indptr = np.zeros(m + 1, dtype=np.int64)
        np.add.at(indptr, uu + 1, 1)
        y = pad_labels(
            Interactions(m=m, n=n, indptr=np.cumsum(indptr), col=vv),
            m_pad, n_pad, dtype=dtype,
            shard_rows=m_pad // blocked_shards,
        )
    else:
        nnz = up(nnz_true + (3 if row_pad else 0))
        pu = np.full(nnz, m, dtype=np.int32)
        pv = np.full(nnz, n, dtype=np.int32)
        pw = np.zeros(nnz, dtype=dtype)
        pu[:nnz_true] = uu
        pv[:nnz_true] = vv
        pw[:nnz_true] = 1.0
        cu = np.zeros(m_pad, dtype=dtype)
        cv = np.zeros(n_pad, dtype=dtype)
        np.add.at(cu, uu, 1.0)
        np.add.at(cv, vv, 1.0)
        y = PaddedLabels(
            nnz=nnz, nnz_true=nnz_true, u=pu, v=pv, w=pw,
            count_u=cu, count_v=cv
        )
    return make_device_data(
        u, v, y, prob.layout, prob.hp, dtype=dtype,
        d_multiple=d_multiple, blocked_bm=blocked_bm,
        blocked_shards=blocked_shards,
    )


def oracle_params_to_jax(params, dtype=np.float64):
    import jax.numpy as jnp

    return {
        f12: {"W": jnp.asarray(params["W"][f12], dtype),
              "H": jnp.asarray(params["H"][f12], dtype)}
        for f12 in params["W"]
    }
