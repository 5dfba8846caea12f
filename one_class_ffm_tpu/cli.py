"""Command-line interface, flag-compatible with the reference trainer.

Reference usage (train.cpp:34-51):
    train [options] item_feature_file train_file
    -l lambda, -t iters, -p test path, -o model save path, -w omega,
    -r negative rating, -c threads, -k rank, --ns, --freq

New flags: --seed, --dtype, --eval-every, --ckpt, --resume, --jsonl,
--predict-topk.  ``-c`` maps to host thread hints (XLA manages device
parallelism itself).
"""

from __future__ import annotations

import argparse
import sys

from .train import NonFiniteMetricError, TrainConfig, Trainer


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ocffm",
        description="One-class FFM trainer",
    )
    p.add_argument("item_file", help="item feature file")
    p.add_argument("train_file", help="training file (labels + user features)")
    p.add_argument("-l", dest="lam", type=float, default=0.1,
                   help="L2 regularization lambda (default 0.1)")
    p.add_argument("-t", dest="nr_pass", type=int, default=20,
                   help="number of epochs (default 20)")
    p.add_argument("-p", dest="test_path", default=None, help="test set path")
    p.add_argument("-o", dest="model_path", default=None,
                   help="save model in reference text format")
    p.add_argument("-w", dest="omega", type=float, default=0.1,
                   help="negative-pair weight omega (default 0.1)")
    p.add_argument("-r", dest="r", type=float, default=-1.0,
                   help="imputed rating for negatives (default -1)")
    p.add_argument("-c", dest="threads", type=int, default=0,
                   help="host threads (0 = library default)")
    p.add_argument("-k", dest="k", type=int, default=4, help="rank (default 4)")
    p.add_argument("--ns", action="store_true",
                   help="disable self-field interactions (cross blocks only)")
    p.add_argument("--freq", action="store_true",
                   help="frequency-weighted lambda")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dtype", default="auto",
                   choices=["auto", "float32", "float64", "bfloat16"],
                   help="storage dtype; auto = bfloat16 on the GPU, float32 "
                        "on the CPU (float32 runs use full float32 matmul "
                        "precision, not TF32)")
    p.add_argument("--eval-every", type=int, default=10)
    p.add_argument("--eval-chunk", type=int, default=1024)
    p.add_argument("--ckpt", dest="ckpt_dir", default=None,
                   help="native checkpoint directory (save + resume)")
    p.add_argument("--resume", action="store_true",
                   help="resume from --ckpt if a checkpoint exists")
    p.add_argument("--ckpt-format", default="npz", choices=["npz", "orbax"],
                   help="checkpoint format: npz (single-host) or orbax "
                        "(sharded-native, async-capable)")
    p.add_argument("--jsonl", dest="jsonl_path", default=None,
                   help="append structured metrics JSONL here")
    p.add_argument("--predict-topk", type=int, default=0,
                   help="after training, print top-K item ids per test user")
    p.add_argument("--platform", default="auto",
                   choices=["auto", "cpu", "gpu"],
                   help="JAX platform (auto = the GPU when one is visible; "
                        "an explicit platform that is not there is an error)")
    p.add_argument("--profile-dir", default=None,
                   help="write a jax.profiler trace here (TensorBoard format)")
    p.add_argument("--timing", action="store_true",
                   help="print per-phase timing summary at the end")
    p.add_argument("--init-model", default=None,
                   help="warm-start from a saved text model (ours or the "
                        "reference's)")
    p.add_argument("--mesh", dest="mesh_shape", default=None,
                   help="device mesh: 'auto' (all devices, data-parallel), "
                        "'N' (N-device data mesh), or 'NxM' (N-way data x "
                        "M-way model axes; large tables row-shard on model)")
    p.add_argument("--model-min-rows", dest="model_min_rows", type=int,
                   default=4096,
                   help="row-shard tables with >= this many rows on the "
                        "model axis of an NxM mesh (default 4096)")
    p.add_argument("--eval-shard", dest="eval_shard", default="auto",
                   choices=["auto", "users", "items"],
                   help="eval sharding axis on a mesh: users (row-DP) or "
                        "items (catalog-sharded top-K merge; scales to "
                        "catalogs the dense path cannot hold). auto picks "
                        "items for large catalogs")
    p.add_argument("--cg-precond", dest="cg_precond", default="auto",
                   choices=["auto", "jacobi", "none"],
                   help="CG flavor: auto = none (reference-exact plain "
                        "CG, ffm.cpp:744-813 — jacobi measured distorting "
                        "converged-state ranking quality at sweep scale, "
                        "docs/PARITY.md), jacobi (diagonal-preconditioned "
                        "opt-in, same stop rule)")
    p.add_argument("--blocked-bm", dest="blocked_bm", type=int, default=256,
                   help="rows per block for the blocked-sorted positive "
                        "passes (per-block one-hot matmuls); "
                        "0 = plain COO ops (default 256; auto-falls-back "
                        "when the stream's row skew would over-pad)")
    p.add_argument("--distributed", action="store_true",
                   help="multi-host: jax.distributed.initialize() from env "
                        "(JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / "
                        "JAX_PROCESS_ID) before building the mesh")
    p.add_argument("--refresh-every", dest="refresh_every", type=int,
                   default=None,
                   help="re-derive the incremental caches from the tables "
                        "every N epochs (default auto: 10 at bf16 storage "
                        "— bounds the bookkeeping drift that diverges at "
                        "sweep scale; 0 disables)")
    p.add_argument("--no-nan-guard", dest="nan_guard", action="store_false",
                   help="disable the finiteness tripwire (by default a "
                        "NaN/inf eval metric aborts the run, naming the "
                        "poisoned blocks)")
    p.add_argument("--max-ploss", dest="max_ploss", type=float, default=50.0,
                   help="divergence tripwire: abort when eval ploss exceeds "
                        "this (reference corpus maxes at 5.4; a finite "
                        "explosion prints ~77+ at its first bad eval; "
                        "0 disables)")
    p.add_argument("--verbose", action="store_true",
                   help="print dataset/model summary before training")
    p.add_argument("--config", default=None,
                   help="JSON file of TrainConfig fields; explicit CLI flags "
                        "override it")
    return p


def config_from_args(args) -> TrainConfig:
    return TrainConfig(
        item_path=args.item_file,
        train_path=args.train_file,
        test_path=args.test_path,
        model_path=args.model_path,
        ckpt_dir=args.ckpt_dir,
        k=args.k,
        lam=args.lam,
        omega=args.omega,
        r=args.r,
        nr_pass=args.nr_pass,
        self_side=not args.ns,
        freq=args.freq,
        seed=args.seed,
        dtype=args.dtype,
        eval_every=args.eval_every,
        eval_chunk=args.eval_chunk,
        jsonl_path=args.jsonl_path,
        resume=args.resume,
        profile_dir=args.profile_dir,
        timing=args.timing,
        ckpt_format=args.ckpt_format,
        init_model=args.init_model,
        mesh_shape=args.mesh_shape,
        model_min_rows=args.model_min_rows,
        distributed=args.distributed,
        eval_shard=args.eval_shard,
        cg_precond=args.cg_precond,
        blocked_bm=args.blocked_bm,
        nan_guard=args.nan_guard,
        max_ploss=args.max_ploss,
        refresh_every=args.refresh_every,
    )


def main(argv=None) -> int:
    import os

    args = build_parser().parse_args(argv)
    if args.threads:
        os.environ.setdefault("XLA_CPU_MULTI_THREAD_EIGEN", "true")
        os.environ.setdefault("OMP_NUM_THREADS", str(args.threads))
    from . import platform

    try:
        platform.select(args.platform)
    except platform.PlatformError as e:
        print(f"ocffm: error: {e}", file=sys.stderr)
        return 1
    # persistent compile cache: repeat invocations (sweeps, resume) skip
    # recompiling the epoch/eval programs
    platform.enable_compile_cache()
    cfg = config_from_args(args)
    if args.config:
        import dataclasses
        import json

        with open(args.config) as fh:
            overrides = json.load(fh)
        valid = {f.name for f in dataclasses.fields(cfg)}
        bad = set(overrides) - valid
        if bad:
            print(f"ocffm: error: unknown config keys: {sorted(bad)}",
                  file=sys.stderr)
            return 1
        # config file fills fields the CLI left at defaults; explicit CLI
        # flags win (argparse gives no provenance, so compare to defaults)
        defaults = config_from_args(build_parser().parse_args(
            [args.item_file, args.train_file]
        ))
        merged = {}
        for f in dataclasses.fields(cfg):
            cli_val = getattr(cfg, f.name)
            if f.name in overrides and cli_val == getattr(defaults, f.name):
                merged[f.name] = overrides[f.name]
            else:
                merged[f.name] = cli_val
        cfg = type(cfg)(**merged)
    # validate the MERGED config (a config file can set/override paths)
    if cfg.k < 1:
        build_parser().error(f"-k must be >= 1 (got {cfg.k})")
    if cfg.nr_pass < 0:
        build_parser().error(f"-t must be >= 0 (got {cfg.nr_pass})")
    for path, what in [(cfg.item_path, "item file"), (cfg.train_path, "train file")] + (
        [(cfg.test_path, "test file")] if cfg.test_path else []
    ):
        if not os.path.exists(path):
            print(f"ocffm: error: {what} not found: {path}", file=sys.stderr)
            return 1
    trainer = Trainer(cfg)
    if args.verbose:
        trainer.describe()
    try:
        trainer.run()
    except NonFiniteMetricError as e:
        print(f"ocffm: error: {e}", file=sys.stderr)
        return 2
    if args.predict_topk and trainer.evaluator is not None:
        top = trainer.predict_topk(k=args.predict_topk)
        for row in top:
            print(",".join(str(int(x)) for x in row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
