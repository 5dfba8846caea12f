"""Standalone scorer / predictor.

The reference's Makefile cleans a ``predict`` binary that was never built
(reference Makefile:36) — inference there means re-running validate().  This
is the real scorer: load a saved model (reference text format or native
checkpoint), score users from a feature file over the full item catalog, and
emit top-K item ids (optionally with scores), with the same cold-user
popularity fallback as evaluation.

Usage:
    python -m one_class_ffm_tpu.predict model.txt items.ffm users.ffm -k 10
    python -m one_class_ffm_tpu.predict --ckpt ckpt_dir items.ffm users.ffm
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, Optional

import numpy as np

from . import platform
from .data.dataset import pad_fields, read_data, split_fields
from .models.blocks import BlockLayout
from .train import load_checkpoint, load_text_model


def load_any_model(model_path: Optional[str], ckpt_dir: Optional[str]):
    """Returns (layout, k, params) from a text model or native checkpoint."""
    if model_path:
        return load_text_model(model_path)
    assert ckpt_dir
    import json
    import os

    params, _ = load_checkpoint(ckpt_dir)
    with open(os.path.join(ckpt_dir, "config.json")) as fh:
        cfg = json.load(fh)
    k = int(cfg["k"])
    lay = cfg.get("layout")
    if lay is None:
        raise ValueError(
            "checkpoint config.json has no 'layout' entry (older checkpoint); "
            "export a text model with -o and use that instead"
        )
    layout = BlockLayout.make(lay["Du"], lay["Dv"], bool(lay["self_side"]))
    return layout, k, params


def predict_topk_from_model(
    layout: BlockLayout,
    k_rank: int,
    params: Dict[int, Dict[str, np.ndarray]],
    item_path: str,
    user_path: str,
    top_k: int,
    catalog: Optional[int] = None,
    popular: Optional[np.ndarray] = None,
    chunk: int = 2048,
    with_scores: bool = False,
    labeled: bool = False,
):
    """Score every user row over the catalog; returns (ids, scores|None)."""
    import jax
    import jax.numpy as jnp

    from .solver.jax_solver import project

    # the model's field dims are the ds filter for BOTH sides: unseen feature
    # ids in updated item/user files must drop, not clamp into the tables
    v_raw = read_data(item_path, has_label=False, ds=list(layout.Dv))
    v_fd = split_fields(v_raw, f_override=layout.fv)
    v_pad = pad_fields(v_fd, dtype=np.float32)
    u_raw = read_data(user_path, has_label=labeled, ds=list(layout.Du))
    u_fd = split_fields(u_raw, f_override=layout.fu)
    u_pad = pad_fields(u_fd, dtype=np.float32)

    jp = {
        f12: {kk: jnp.asarray(t, jnp.float32) for kk, t in blk.items()}
        for f12, blk in params.items()
    }
    # item-side projections + item self sums
    Q = {}
    for b in layout.cross_blocks():
        Q[b.f12] = project(
            jnp.asarray(v_pad.idx[b.fj]), jnp.asarray(v_pad.val[b.fj]),
            jp[b.f12]["H"],
        )
    bt = jnp.zeros(v_pad.m, jnp.float32)
    for b in layout.item_self_blocks():
        P1 = project(
            jnp.asarray(v_pad.idx[b.fi]), jnp.asarray(v_pad.val[b.fi]),
            jp[b.f12]["W"],
        )
        Q1 = project(
            jnp.asarray(v_pad.idx[b.fj]), jnp.asarray(v_pad.val[b.fj]),
            jp[b.f12]["H"],
        )
        bt = bt + jnp.sum(P1 * Q1, axis=1)

    cat = int(min(catalog or v_fd.m, v_fd.m))
    pop = np.zeros(v_pad.m, np.float32)
    if popular is not None:
        npop = min(len(popular), v_pad.m)
        pop[:npop] = popular[:npop]

    @jax.jit
    def score(uidx, uval, cold):
        z = jnp.broadcast_to(bt[None, :], (uidx[0].shape[0], v_pad.m))
        for b in layout.cross_blocks():
            P1 = project(uidx[b.fi], uval[b.fi], jp[b.f12]["W"])
            z = z + P1 @ Q[b.f12].T
        z = jnp.where(cold[:, None], jnp.asarray(pop)[None, :], z)
        return jax.lax.top_k(z[:, :cat], top_k)

    ids_out, score_out = [], []
    cold_all = u_pad.row_nnz == 0
    for lo in range(0, u_fd.m, chunk):
        sl = slice(lo, lo + chunk)
        uidx = tuple(jnp.asarray(a[sl]) for a in u_pad.idx)
        uval = tuple(jnp.asarray(a[sl]) for a in u_pad.val)
        with platform.precision_scope(jnp.float32):
            vals, ids = score(uidx, uval, jnp.asarray(cold_all[sl]))
        ids_out.append(np.asarray(ids))
        score_out.append(np.asarray(vals))
    ids = np.concatenate(ids_out)[: u_fd.m]
    scores = np.concatenate(score_out)[: u_fd.m] if with_scores else None
    return ids, scores


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ocffm-predict")
    ap.add_argument("model", nargs="?", default=None,
                    help="text model file (from -o / save_text_model)")
    ap.add_argument("item_file")
    ap.add_argument("user_file", help="user feature rows to score (no labels)")
    ap.add_argument("--ckpt", default=None, help="native checkpoint dir instead")
    ap.add_argument("-k", "--top-k", type=int, default=10)
    ap.add_argument("--catalog", type=int, default=None,
                    help="restrict ranking to the first N item ids")
    ap.add_argument("--scores", action="store_true",
                    help="emit id:score pairs instead of bare ids")
    ap.add_argument("--labeled", action="store_true",
                    help="user file rows start with a label block (ignored)")
    ap.add_argument("--popular-from", default=None,
                    help="labeled training file to build the popularity "
                         "prior for cold users (otherwise cold users score 0)")
    ap.add_argument("--platform", default="auto", choices=["auto", "cpu", "gpu"])
    args = ap.parse_args(argv)
    if not args.model and not args.ckpt:
        ap.error("need a text model or --ckpt")
    import os

    for path, what in [(args.model, "model"), (args.item_file, "item file"),
                       (args.user_file, "user file")]:
        if path and not os.path.exists(path):
            print(f"ocffm-predict: error: {what} not found: {path}",
                  file=sys.stderr)
            return 1
    try:
        platform.select(args.platform)
    except platform.PlatformError as e:
        print(f"ocffm-predict: error: {e}", file=sys.stderr)
        return 1
    platform.enable_compile_cache()
    layout, k_rank, params = load_any_model(args.model, args.ckpt)
    popular = None
    if args.popular_from:
        pop_raw = read_data(args.popular_from, has_label=True)
        popular = pop_raw.popular
    else:
        # quality trap guard: featureless users rank by the popularity prior
        # in evaluation (reference ffm.cpp:975-977) but have nothing to rank
        # by here without one — warn rather than silently emit score-0 rows
        u_probe = read_data(args.user_file, has_label=args.labeled,
                            ds=list(layout.Du))
        n_cold = int(np.sum(np.diff(u_probe.x_indptr) == 0))
        if n_cold:
            print(
                f"ocffm-predict: warning: {n_cold} user row(s) have no "
                f"(in-vocabulary) features and will score 0 for every item; "
                f"pass --popular-from <train file> to rank them by the "
                f"popularity prior (the evaluator's cold-user fallback)",
                file=sys.stderr,
            )
    ids, scores = predict_topk_from_model(
        layout, k_rank, params, args.item_file, args.user_file,
        args.top_k, catalog=args.catalog, with_scores=args.scores,
        labeled=args.labeled, popular=popular,
    )
    for i, row in enumerate(ids):
        if args.scores:
            print(",".join(f"{int(j)}:{scores[i][t]:.6g}" for t, j in enumerate(row)))
        else:
            print(",".join(str(int(j)) for j in row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
