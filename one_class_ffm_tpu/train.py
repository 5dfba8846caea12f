"""End-to-end training driver (the reference ``train.cpp`` equivalent).

Wires the data layer -> FFMSolver -> Evaluator and reproduces the reference's
run protocol: load item/train/test files, alternate Gauss-Newton epochs,
validate every ``eval_every`` epochs printing the reference's one-row format
(print_epoch_info, reference ffm.cpp:1130-1145) so the logs.tools scripts
work unchanged, and save the model (reference text format and/or native
checkpoint).

Capabilities beyond the reference: mid-training checkpoint + resume, JSONL
structured metrics, a real predict/top-K scorer, AUC.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .data.dataset import (
    FieldData,
    Interactions,
    PaddedFields,
    PaddedLabels,
    pad_fields,
    pad_labels,
    read_data,
    split_fields,
    trans_y,
)
from .models.blocks import BlockLayout, index_vec
from .solver.params import HyperParams

TOP_KS = (5, 10, 20, 40, 80)


class NonFiniteMetricError(RuntimeError):
    """Raised by the finiteness tripwire when an eval metric goes NaN/inf
    (poisoned model state); see Trainer._check_finite."""


@dataclass
class TrainConfig:
    """Run configuration (reference Option, train.cpp:7-19 + new fields)."""

    item_path: str
    train_path: str
    test_path: Optional[str] = None
    model_path: Optional[str] = None  # reference text-format export (-o)
    ckpt_dir: Optional[str] = None  # native checkpoint directory
    k: int = 4
    lam: float = 0.1  # train.cpp help default
    omega: float = 0.1
    r: float = -1.0
    nr_pass: int = 20
    self_side: bool = True  # --ns sets False
    freq: bool = False
    seed: int = 0
    # "auto": the platform's default storage dtype (platform.DEFAULT_DTYPE:
    # bfloat16 on the GPU, float32 on the CPU)
    dtype: str = "auto"
    eval_every: int = 10  # reference hard-codes 10 (ffm.cpp:1155)
    eval_chunk: int = 1024
    row_multiple: int = 8  # pad rows for even sharding and blocking
    jsonl_path: Optional[str] = None
    resume: bool = False
    profile_dir: Optional[str] = None  # jax.profiler trace output
    timing: bool = False  # print per-phase timing at the end
    ckpt_format: str = "npz"  # "npz" (single-host) | "orbax" (sharded-native)
    init_model: Optional[str] = None  # warm-start from a text model file
    # --- mesh / distributed execution (reference analog: train.cpp:174
    # omp_set_num_threads — the parallelism knob wired into the binary) ---
    mesh_shape: Optional[str] = None  # None | "auto" | "N" | "NxM" (dataxmodel)
    model_min_rows: int = 4096  # row-shard tables >= this on the model axis
    distributed: bool = False  # jax.distributed.initialize() before meshing
    # eval sharding axis: "users" (row-DP), "items" (catalog-sharded top-K
    # merge — scales past the dense (chunk, n) cliff), or "auto" (items when
    # the catalog exceeds eval_item_threshold)
    eval_shard: str = "auto"
    eval_item_threshold: int = 1 << 18
    # CG flavor: "auto" (= "none", the reference-exact plain CG) or
    # "jacobi" (diagonal-preconditioned opt-in)
    cg_precond: str = "auto"
    # rows per block for the blocked-sorted positive ops (segment sums as
    # per-block one-hot matmuls).  0 disables.  Auto-disabled when the
    # stream's row skew would over-pad (ops.make_blocked_layout).  Under a
    # data mesh the u-side runs SHARD-ALIGNED (pad_labels shard_rows= +
    # shard_map-local blocked ops — no per-iteration collectives); the
    # v side keeps the plain COO ops there.
    blocked_bm: int = 256
    # internal: set by Trainer under a data mesh — the stream is laid out
    # shard-aligned over this many shards (0 = flat layout)
    stream_shards: int = 0
    # finiteness tripwire: fail LOUDLY when an eval metric goes NaN/inf
    # instead of logging `ploss: nan` to completion (the round-4 f32 CG
    # underflow trained 90 nan epochs undetected; the reference would have
    # logged nan silently too — ffm.cpp:1002 has no guard)
    nan_guard: bool = True
    # divergence tripwire: ploss (positive-pair RMSE, O(1) for any sane
    # model of +-1-ish targets; the whole 664-log reference corpus tops out
    # at 5.4) above this aborts like the nan guard — a finite explosion
    # (the round-5 bf16 spiral printed ploss 77 at its first bad eval,
    # then 1e9+) must not train on.  0 disables.
    max_ploss: float = 50.0
    # Re-derive the incremental caches (P/Q, a/b, the residual carry yt)
    # from the block tables every N epochs.  The solver, like the
    # reference (init_y_tilde/update_* ffm.cpp:388-465), updates these
    # INCREMENTALLY after every half-solve; at f64 that is harmless, but
    # at bf16 storage the bookkeeping error COMPOUNDS — measured on the
    # k=16 sweep tier: carried-vs-recomputed residual drift reaches ~1%
    # mean by epoch 25, then feeds back through the Gauss-Newton steps and
    # the whole model explodes to |W| ~ 1e3 within 5 more epochs
    # (docs/PARITY.md incident log, round 5).  A periodic re-derivation
    # resets the drift; one refresh is about one gradient pass of work.
    # None = auto: every 10
    # epochs at bf16 storage, off at f32/f64 (f32 holds parity to 100
    # epochs unrefreshed — PARITY.md sweep tier).  0 disables.
    refresh_every: Optional[int] = None

    def hyper(self) -> HyperParams:
        return HyperParams(
            k=self.k,
            lam=self.lam,
            omega=self.omega,
            r=self.r,
            nr_pass=self.nr_pass,
            self_side=self.self_side,
            freq=self.freq,
            cg_precond=self.cg_precond,
        )


def _np_dtype(name: str):
    import jax.numpy as jnp

    if name == "auto":
        from . import platform

        name = platform.default_dtype()
    return {"float32": jnp.float32, "float64": jnp.float64, "bfloat16": jnp.bfloat16}[
        name
    ]


@dataclass
class LoadedData:
    """Everything host-side the trainer needs."""

    layout: BlockLayout
    u_pad: PaddedFields
    v_pad: PaddedFields
    y_pad: PaddedLabels
    popular: np.ndarray
    uva_pad: Optional[PaddedFields]
    va_labels: Optional[List[np.ndarray]]
    n_items_true: int
    m_users_true: int
    nnz_true: int


def load_problem(cfg: TrainConfig) -> LoadedData:
    """Replicates main()'s data pipeline (train.cpp:177-192):
    read train (labels) -> split; read items -> split; test with the train
    Ds filter.  Training positives with item id >= item-file rows are dropped
    (the reference drops them in transY, ffm.cpp:267-268)."""
    u_raw = read_data(cfg.train_path, has_label=True)
    u_fd = split_fields(u_raw)
    v_raw = read_data(cfg.item_path, has_label=False)
    v_fd = split_fields(v_raw)

    layout = BlockLayout.make(u_fd.Ds, v_fd.Ds, cfg.self_side)

    dt = np.float64 if cfg.dtype == "float64" else np.float32
    mult = max(1, cfg.row_multiple)
    u_pad = pad_fields(u_fd, row_multiple=mult, dtype=dt)
    v_pad = pad_fields(v_fd, row_multiple=mult, dtype=dt)

    # training positives: COO with v < item rows
    assert u_raw.y is not None
    uu = u_raw.y.row_ids()
    vv = u_raw.y.col
    keep = vv < v_fd.m
    y = Interactions(
        m=u_fd.m,
        n=v_fd.m,
        indptr=_rebuild_indptr(uu[keep], u_fd.m),
        col=vv[keep],
    )
    y_pad = pad_labels(
        y, u_pad.m, v_pad.m, nnz_multiple=mult * 8, dtype=dt,
        shard_rows=(u_pad.m // cfg.stream_shards
                    if cfg.stream_shards > 1 else 0),
    )

    uva_pad = None
    va_labels = None
    if cfg.test_path:
        t_raw = read_data(cfg.test_path, has_label=True, ds=u_fd.Ds)
        t_fd = split_fields(t_raw, f_override=u_fd.f)
        uva_pad = pad_fields(t_fd, row_multiple=mult, dtype=dt)
        assert t_raw.y is not None
        va_labels = [
            t_raw.y.col[t_raw.y.indptr[i] : t_raw.y.indptr[i + 1]]
            for i in range(t_raw.m)
        ]

    assert u_raw.popular is not None
    return LoadedData(
        layout=layout,
        u_pad=u_pad,
        v_pad=v_pad,
        y_pad=y_pad,
        popular=u_raw.popular,
        uva_pad=uva_pad,
        va_labels=va_labels,
        n_items_true=v_fd.m,
        m_users_true=u_fd.m,
        nnz_true=y_pad.nnz_true,
    )


def _lcm(a: int, b: int) -> int:
    import math

    return a * b // math.gcd(a, b)


def _rebuild_indptr(rows: np.ndarray, m: int) -> np.ndarray:
    ptr = np.zeros(m + 1, dtype=np.int64)
    np.add.at(ptr, rows + 1, 1)
    return np.cumsum(ptr)


class Trainer:
    """Owns the solver + evaluator for one run."""

    def __init__(self, cfg: TrainConfig, data: Optional[LoadedData] = None):
        import jax

        from .evalx.jax_eval import Evaluator, make_eval_data
        from .solver.jax_solver import FFMSolver, make_device_data

        # mesh resolution BEFORE data layout: the data layer's padding
        # multiples must divide the data axis, and table dims the model axis
        if cfg.distributed:
            from .parallel.distributed import init_distributed

            init_distributed()
        from .parallel.mesh import resolve_mesh

        self.mesh = resolve_mesh(cfg.mesh_shape)
        n_data = 1
        n_model = 1
        if self.mesh is not None:
            n_data = int(self.mesh.shape.get("data", 1))
            n_model = int(self.mesh.shape.get("model", 1))
            # u-side blocked ops stay on under the mesh via the shard-
            # aligned stream (pad_labels shard_rows=) + shard_map-local
            # passes; rows must divide n_data * blocked_bm so shard and
            # block boundaries nest.  v side falls back to plain COO ops.
            row_mult = n_data * cfg.blocked_bm if cfg.blocked_bm else n_data
            cfg = dataclasses.replace(
                cfg,
                row_multiple=_lcm(max(1, cfg.row_multiple), row_mult),
                eval_chunk=_lcm(max(1, cfg.eval_chunk), n_data),
                stream_shards=n_data if (cfg.blocked_bm and n_data > 1)
                else 0,
            )
        elif cfg.blocked_bm > 0:
            # user rows must divide the block size for the blocked layout
            cfg = dataclasses.replace(
                cfg,
                row_multiple=_lcm(max(1, cfg.row_multiple), cfg.blocked_bm),
            )
        self.cfg = cfg
        self.data = data if data is not None else load_problem(cfg)
        d = self.data
        dtype = _np_dtype(cfg.dtype)
        meta, dev = make_device_data(
            d.u_pad, d.v_pad, d.y_pad, d.layout, cfg.hyper(), dtype=dtype,
            d_multiple=n_model, blocked_bm=cfg.blocked_bm,
            blocked_shards=max(1, cfg.stream_shards),
        )
        if self.mesh is not None:
            from .parallel.mesh import shard_data

            dev = shard_data(dev, self.mesh)
        self.meta = meta
        self.solver = FFMSolver(meta, dev, mesh=self.mesh)
        self.evaluator = None
        if d.uva_pad is not None and d.va_labels:
            emeta, edata = make_eval_data(
                d.uva_pad,
                d.va_labels,
                d.popular,
                n_items=d.v_pad.m,
                n_items_true=d.n_items_true,
                layout=d.layout,
                dtype=dtype,
                top_ks=TOP_KS,
            )
            self.evaluator = Evaluator(emeta, edata, chunk=cfg.eval_chunk)
            if self.mesh is not None:
                by_items = cfg.eval_shard == "items" or (
                    cfg.eval_shard == "auto"
                    and emeta.n >= cfg.eval_item_threshold
                )
                if by_items:
                    self.evaluator = self.evaluator.shard_items(self.mesh)
                else:
                    self.evaluator = self.evaluator.shard(self.mesh)
        self.state = None
        self.epoch_idx = 0
        self._jax = jax
        # resolved cache-refresh cadence (see TrainConfig.refresh_every):
        # bf16's incremental bookkeeping drift must be reset periodically
        import jax.numpy as jnp

        if cfg.refresh_every is not None:
            self.refresh_every = int(cfg.refresh_every)
        else:
            self.refresh_every = 10 if dtype == jnp.bfloat16 else 0
        from .utils import PhaseTimer

        self.timer = PhaseTimer()

    def _place_state(self, state):
        """Shard freshly built solver state over the trainer's mesh (no-op
        single-device)."""
        if self.mesh is None:
            return state
        from .parallel.mesh import shard_state

        n_model = int(self.mesh.shape.get("model", 1))
        return shard_state(
            state,
            self.mesh,
            model_min_rows=self.cfg.model_min_rows if n_model > 1 else None,
        )

    # -- lifecycle ------------------------------------------------------------

    def init_state(self):
        import jax

        if self.cfg.ckpt_format == "orbax":
            from .utils import orbax_ckpt as _oc

            found = self.cfg.ckpt_dir and _oc.has_checkpoint(self.cfg.ckpt_dir)
        else:
            found = self.cfg.ckpt_dir and has_checkpoint(self.cfg.ckpt_dir)
        if self.cfg.resume and found:
            self.load_checkpoint()
        elif self.cfg.init_model:
            self.warm_start(self.cfg.init_model)
        else:
            self.state = self.solver.init(jax.random.key(self.cfg.seed))
            self.epoch_idx = 0
        self.state = self._place_state(self.state)
        return self.state

    def warm_start(self, model_path: str):
        """Initialize from a saved text model (ours or the reference's own
        save_model output, ffm.cpp:1163-1237) and continue training."""
        import jax.numpy as jnp

        layout, k, params_np = load_text_model(model_path)
        lay = self.data.layout
        if k != self.cfg.k:
            raise ValueError(f"model k={k} != config k={self.cfg.k}")
        if (layout.fu, layout.fv) != (lay.fu, lay.fv):
            raise ValueError(
                f"model fields ({layout.fu},{layout.fv}) != data "
                f"({lay.fu},{lay.fv})"
            )
        dtype = _np_dtype(self.cfg.dtype)
        params = {}
        for b in lay.all_blocks():
            blk = params_np[b.f12]
            W = np.zeros((self.meta.pad_d(b.d1), k))
            H = np.zeros((self.meta.pad_d(b.d2), k))
            # model dims may be smaller than this dataset's (new features
            # since the model was trained): those rows start at zero
            w_src, h_src = blk["W"], blk["H"]
            W[: min(b.d1, w_src.shape[0])] = w_src[: b.d1]
            H[: min(b.d2, h_src.shape[0])] = h_src[: b.d2]
            params[b.f12] = {
                "W": jnp.asarray(W, dtype), "H": jnp.asarray(H, dtype)
            }
        self.state = self.solver.refresh_caches({"params": params})
        self.epoch_idx = 0

    def describe(self, log=print):
        """Dataset summary (reference print_data_info, ffm.cpp:296-312)."""
        d = self.data
        cfg = self.cfg
        log(f"train: {cfg.train_path}  users={d.m_users_true} "
            f"fields={d.u_pad.f} dims={list(d.u_pad.Ds)} "
            f"positives={d.nnz_true}")
        log(f"items: {cfg.item_path}  items={d.n_items_true} "
            f"fields={d.v_pad.f} dims={list(d.v_pad.Ds)} "
            f"catalog={len(d.popular)}")
        if d.uva_pad is not None:
            n_labels = sum(len(l) for l in d.va_labels)
            log(f"test:  {cfg.test_path}  users={len(d.va_labels)} "
                f"labels={n_labels}")
        blocks = d.layout.all_blocks()
        n_params = sum(b.d1 * cfg.k + b.d2 * cfg.k for b in blocks)
        log(f"model: k={cfg.k} blocks={len(blocks)} "
            f"(self_side={cfg.self_side}) params={n_params:,}")

    # -- training loop --------------------------------------------------------

    def run(self, log=print) -> Dict[str, float]:
        """Full solve loop (reference solve(), ffm.cpp:1147-1161)."""
        cfg = self.cfg
        if self.state is None:
            self.init_state()
        self._print_header(log)
        metrics: Dict[str, float] = {}
        from .utils import trace_profile

        with trace_profile(cfg.profile_dir):
            while self.epoch_idx < cfg.nr_pass:
                t0 = time.time()
                with self.timer.phase("epoch"):
                    self.state = self.solver.epoch(self.state)
                    self._jax.block_until_ready(self.state)
                self.epoch_idx += 1
                t_epoch = time.time() - t0
                if (
                    self.refresh_every
                    and self.epoch_idx % self.refresh_every == 0
                ):
                    # re-derive P/Q/a/b/yt from the tables: bounds the
                    # incremental bf16 bookkeeping drift that otherwise
                    # compounds into divergence (PARITY.md incident log)
                    with self.timer.phase("refresh"):
                        self.state = self._place_state(
                            self.solver.refresh_caches(
                                {"params": self.state["params"]}))
                if (
                    self.evaluator is not None
                    and self.epoch_idx % cfg.eval_every == 0
                ):
                    with self.timer.phase("validate"):
                        metrics = self.validate()
                    self._check_finite(metrics)
                    log(self._format_row(self.epoch_idx, metrics))
                    self._write_jsonl(self.epoch_idx, metrics, t_epoch)
                if cfg.ckpt_dir and self.epoch_idx % cfg.eval_every == 0:
                    with self.timer.phase("checkpoint"):
                        self.save_checkpoint()
        if cfg.model_path:
            save_text_model(
                cfg.model_path, self.params_numpy(), self.data.layout, cfg.k
            )
        if cfg.ckpt_dir:
            self.save_checkpoint()
        if cfg.timing:
            self.timer.report(log)
        return metrics

    def validate(self) -> Dict[str, float]:
        assert self.evaluator is not None
        st = self.state
        return self.evaluator.validate(st["params"], st["Q"], st["b"])

    def _check_finite(self, metrics: Dict[str, float]):
        """Finiteness tripwire (VERDICT r4 #6): a non-finite eval metric
        means the model state is poisoned (e.g. the round-4 f32 CG underflow
        put inf into table rows and the trainer printed `ploss: nan` for 90
        more epochs).  Fail loudly at the FIRST bad eval, naming the
        offending blocks, instead of logging nan to completion."""
        if not self.cfg.nan_guard:
            return
        bad = sorted(
            k for k, v in metrics.items() if not math.isfinite(float(v)))
        if (not bad and self.cfg.max_ploss
                and float(metrics.get("ploss", 0.0)) > self.cfg.max_ploss):
            bad = [f"ploss={float(metrics['ploss']):.3g} > "
                   f"max_ploss={self.cfg.max_ploss:g} (diverged)"]
        if not bad:
            return
        culprits = []
        for f12, blk in sorted(self.state["params"].items()):
            for name in ("W", "H"):
                arr = np.asarray(blk[name], dtype=np.float32)
                n_bad = int(np.size(arr) - np.isfinite(arr).sum())
                if n_bad:
                    culprits.append(f"{name}[f12={f12}] ({n_bad} entries)")
        raise NonFiniteMetricError(
            f"non-finite eval metrics at epoch {self.epoch_idx}: "
            f"{', '.join(bad)}; non-finite table blocks: "
            f"{', '.join(culprits) if culprits else 'none (eval-side)'}. "
            "Training aborted — the model state is poisoned and every "
            "further epoch would train on it (disable with --no-nan-guard "
            "for forensics)."
        )

    # -- io -------------------------------------------------------------------

    def params_numpy(self) -> Dict[int, Dict[str, np.ndarray]]:
        """Host copies of the block tables, sliced to TRUE field dims (the
        solver may carry pad rows for model-axis sharding; exports and the
        reference text format must not contain them)."""
        dims = {b.f12: (b.d1, b.d2) for b in self.data.layout.all_blocks()}
        return {
            f12: {
                "W": np.asarray(blk["W"])[: dims[f12][0]],
                "H": np.asarray(blk["H"])[: dims[f12][1]],
            }
            for f12, blk in self.state["params"].items()
        }

    def save_checkpoint(self):
        lay = self.data.layout
        layout_doc = dict(
            fu=lay.fu, fv=lay.fv, Du=list(lay.Du), Dv=list(lay.Dv),
            self_side=lay.self_side,
        )
        if self.cfg.ckpt_format == "orbax":
            from .utils import orbax_ckpt

            orbax_ckpt.save(
                self.cfg.ckpt_dir, self.state["params"], self.epoch_idx,
                meta=dict(k=self.cfg.k, layout=layout_doc),
            )
            return
        save_checkpoint(
            self.cfg.ckpt_dir,
            self.params_numpy(),
            self.epoch_idx,
            self.cfg,
            layout=layout_doc,
        )

    def load_checkpoint(self):
        import jax.numpy as jnp

        if self.cfg.ckpt_format == "orbax":
            from .utils import orbax_ckpt

            params, epoch = orbax_ckpt.load(self.cfg.ckpt_dir)
            self.state = self.solver.refresh_caches({"params": params})
            self.epoch_idx = epoch
            return
        params_np, epoch = load_checkpoint(self.cfg.ckpt_dir)
        dtype = _np_dtype(self.cfg.dtype)
        params = {
            f12: {
                k: jnp.asarray(self._pad_table(v), dtype)
                for k, v in blk.items()
            }
            for f12, blk in params_np.items()
        }
        self.state = self.solver.refresh_caches({"params": params})
        self.epoch_idx = epoch

    def _pad_table(self, t: np.ndarray) -> np.ndarray:
        """Round a checkpointed table's row dim up to the solver's d_multiple
        (checkpoints store true dims; pad rows are zero by invariant)."""
        dp = self.meta.pad_d(t.shape[0])
        if dp == t.shape[0]:
            return t
        return np.pad(t, [(0, dp - t.shape[0]), (0, 0)])

    # -- output formatting (log-tooling compatible) ---------------------------

    def _print_header(self, log):
        if self.evaluator is None:
            return
        cols = ["iter"]
        for k in TOP_KS:
            cols.append(f"( p@ {k}, nDCG@{k} )")
        cols.append("ploss")
        log(" ".join(cols))

    def _format_row(self, t: int, m: Dict[str, float]) -> str:
        """One validation row, reference format: metrics x100, %.3g
        (print_epoch_info, ffm.cpp:1130-1145)."""
        parts = [f"{t:>2}"]
        for k in TOP_KS:
            parts.append(f"( {m[f'p@{k}'] * 100:.3g} , {m[f'ndcg@{k}'] * 100:.3g} )")
        parts.append(f"{m['ploss']:.3g}")
        return " ".join(parts)

    def _write_jsonl(self, t: int, m: Dict[str, float], t_epoch: float):
        if not self.cfg.jsonl_path:
            return
        rec = dict(
            epoch=t,
            epoch_seconds=t_epoch,
            examples_per_sec=self.data.m_users_true / max(t_epoch, 1e-9),
            **m,
        )
        with open(self.cfg.jsonl_path, "a") as fh:
            fh.write(json.dumps(rec) + "\n")

    # -- prediction (capability the reference lacks) --------------------------

    def predict_topk(self, k: int = 10, chunk: int = 1024) -> np.ndarray:
        """Top-k item ids for every test user (cold users ranked by
        popularity), using the current parameters."""
        assert self.evaluator is not None
        import jax
        import jax.numpy as jnp

        from . import platform

        ev = self.evaluator
        Pva, _ = ev._project_users(self.state["params"])
        meta = ev.meta
        Q = self.state["Q"]
        bt = self.state["b"]
        outs = []

        if ev._item_mesh is not None:
            # catalog-sharded serving: the same top-K-merge path eval uses
            from .evalx.sharded_topk import make_sharded_topk_fn

            f12s = [b.f12 for b in meta.layout.cross_blocks()]
            fn = make_sharded_topk_fn(
                f12s, ev._item_mesh, k, axis=ev._item_axis,
                catalog=meta.catalog,
            )
            Qc = {f12: Q[f12] for f12 in f12s}
            for lo in range(0, meta.mt_true, chunk):
                sl = slice(lo, lo + chunk)
                Pc = {f12: P[sl] for f12, P in Pva.items()}
                with platform.precision_scope(meta.dtype):
                    _, ids = fn(Pc, ev.data["cold"][sl], Qc, bt,
                                ev.data["popular"])
                outs.append(np.asarray(ids))
            return np.concatenate(outs, axis=0)[: meta.mt_true]

        @jax.jit
        def score(Pc, cold_c):
            z = jnp.broadcast_to(bt[None, :], (cold_c.shape[0], meta.n))
            for b in meta.layout.cross_blocks():
                z = z + Pc[b.f12] @ Q[b.f12].T
            z = jnp.where(cold_c[:, None], ev.data["popular"][None, :], z)
            return jax.lax.top_k(z[:, : meta.catalog], k)[1]

        for lo in range(0, meta.mt_true, chunk):
            sl = slice(lo, lo + chunk)
            Pc = {f12: P[sl] for f12, P in Pva.items()}
            with platform.precision_scope(meta.dtype):
                outs.append(np.asarray(score(Pc, ev.data["cold"][sl])))
        return np.concatenate(outs, axis=0)[: meta.mt_true]


# ---------------------------------------------------------------------------
# Model persistence
# ---------------------------------------------------------------------------


def save_text_model(
    path: str,
    params: Dict[int, Dict[str, np.ndarray]],
    layout: BlockLayout,
    k: int,
):
    """Reference text model format (save_model, ffm.cpp:1163-1237):
    header f/fu/fv/k + per-field dims, then per block rows
    ``W,fi,fj,row v1 .. vk`` in %g formatting."""
    f = layout.f
    with open(path, "w") as out:
        out.write(f"{f}\n{layout.fu}\n{layout.fv}\n{k}\n")
        for d in layout.Du:
            out.write(f"{d}\n")
        for d in layout.Dv:
            out.write(f"{d}\n")

    def native_write(name, b, tbl) -> bool:
        try:
            from .data.native_io import write_block_native

            return write_block_native(path, name, b.f1, b.f2, tbl)
        except Exception:
            return False

    for b in layout.all_blocks():
        for name in ("W", "H"):
            tbl = np.asarray(params[b.f12][name], dtype=np.float64)
            if native_write(name, b, tbl):
                continue
            with open(path, "a") as out:
                for row in range(tbl.shape[0]):
                    vals = " ".join(_fmt_g(x) for x in tbl[row])
                    out.write(f"{name},{b.f1},{b.f2},{row} {vals}\n")


def _fmt_g(x: float) -> str:
    """C++ default ostream float formatting (6 significant digits)."""
    return f"{float(x):.6g}"


def load_text_model(path: str):
    """Parse the text model back into (layout metadata, params).

    Dispatches the body (the multi-GB part on production models) to the C++
    reader (native/parser.cpp ocffm_read_model) when built, falling back to
    the pure-Python parser."""
    with open(path) as fh:
        header: List[str] = []
        while True:
            header.append(fh.readline())
            # f, fu, fv, k read first; then fu+fv dim lines
            if len(header) >= 4:
                fu = int(header[1])
                fv = int(header[2])
                if len(header) == 4 + fu + fv:
                    break
        offset = fh.tell()
    f = int(header[0])
    fu = int(header[1])
    fv = int(header[2])
    k = int(header[3])
    Du = [int(header[4 + i]) for i in range(fu)]
    Dv = [int(header[4 + fu + i]) for i in range(fv)]

    flat = None
    try:
        from .data.native_io import read_model_body_native

        flat = read_model_body_native(path, offset, k)
    except Exception:
        flat = None

    tables: Dict[Tuple[str, int, int], Dict[int, Any]] = {}
    if flat is not None:
        names, bf1, bf2, brow, vals = flat
        # group rows into block tables (vectorized: sort by block key)
        for code, nm in ((0, "W"), (1, "H")):
            msk = names == code
            keys = bf1[msk].astype(np.int64) * (f + 1) + bf2[msk]
            rows_b = brow[msk]
            vals_b = vals[msk]
            for key in np.unique(keys):
                sel = keys == key
                f1i, f2i = int(key // (f + 1)), int(key % (f + 1))
                d = int(rows_b[sel].max()) + 1
                arr = np.zeros((d, k))
                arr[rows_b[sel]] = vals_b[sel]
                tables[(nm, f1i, f2i)] = arr
    else:
        with open(path) as fh:
            fh.seek(offset)
            acc: Dict[Tuple[str, int, int], Dict[int, List[float]]] = {}
            for ln in fh:
                ln = ln.strip()
                if not ln:
                    continue
                head, v = ln.split(" ", 1)
                name, f1s, f2s, row = head.split(",")
                key = (name, int(f1s), int(f2s))
                acc.setdefault(key, {})[int(row)] = [float(x) for x in v.split()]
        for key, rows in acc.items():
            d = max(rows) + 1
            arr = np.zeros((d, k))
            for r, v in rows.items():
                arr[r] = v
            tables[key] = arr

    # reconstruct self_side from which blocks exist
    self_side = any(
        (f1 < fu and f2 < fu) or (f1 >= fu and f2 >= fu)
        for (_, f1, f2) in tables.keys()
    )
    layout = BlockLayout.make(Du, Dv, self_side)
    params: Dict[int, Dict[str, np.ndarray]] = {}
    for b in layout.all_blocks():
        params[b.f12] = {
            "W": tables[("W", b.f1, b.f2)],
            "H": tables[("H", b.f1, b.f2)],
        }
    return layout, k, params


# ---------------------------------------------------------------------------
# Native checkpointing (capability the reference lacks: resume mid-training)
# ---------------------------------------------------------------------------


def save_checkpoint(
    ckpt_dir: str,
    params: Dict[int, Dict[str, np.ndarray]],
    epoch: int,
    cfg: TrainConfig,
    layout: Optional[Dict] = None,
):
    os.makedirs(ckpt_dir, exist_ok=True)
    arrays = {}
    def storable(v: np.ndarray) -> np.ndarray:
        # np.load round-trips ml_dtypes.bfloat16 as an opaque |V2 void dtype
        # (no cast function) — store non-native float dtypes as f32 (lossless
        # upcast from bf16).  Native f32/f64 keep their precision.
        if v.dtype in (np.float32, np.float64):
            return v
        return np.asarray(v, np.float32)

    for f12, blk in params.items():
        arrays[f"W_{f12}"] = storable(blk["W"])
        arrays[f"H_{f12}"] = storable(blk["H"])
    tmp = os.path.join(ckpt_dir, ".ckpt.tmp.npz")
    np.savez(tmp, epoch=np.int64(epoch), **arrays)
    os.replace(tmp, os.path.join(ckpt_dir, "ckpt.npz"))
    doc = dataclasses.asdict(cfg)
    if layout is not None:
        doc["layout"] = layout
    with open(os.path.join(ckpt_dir, "config.json"), "w") as fh:
        json.dump(doc, fh, indent=2)


def has_checkpoint(ckpt_dir: str) -> bool:
    return os.path.exists(os.path.join(ckpt_dir, "ckpt.npz"))


def load_checkpoint(ckpt_dir: str):
    z = np.load(os.path.join(ckpt_dir, "ckpt.npz"))
    params: Dict[int, Dict[str, np.ndarray]] = {}
    for key in z.files:
        if key == "epoch":
            continue
        name, f12 = key.split("_")
        v = z[key]
        if v.dtype.kind == "V" and v.dtype.itemsize == 2:
            # legacy checkpoint written with bf16 tables: numpy loads the
            # ml_dtypes.bfloat16 descr as an opaque 2-byte void — reinterpret
            import ml_dtypes

            v = v.view(ml_dtypes.bfloat16).astype(np.float32)
        params.setdefault(int(f12), {})[name] = v
    return params, int(z["epoch"])
