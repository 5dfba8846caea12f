"""Statistical metric-parity harness: C++ reference vs this JAX trainer.

The reference's init is an unseeded libc ``rand()`` (deterministic per
process, /root/reference/ffm.cpp:71-78), so single-run comparisons prove
little: the right instrument is N paired trials over independently generated
datasets, comparing per-metric MEANS within combined run-to-run variance.

For every model variant (the reference capability matrix, SURVEY.md §2.3):

    ffm-ffm      multi-field user+item, self blocks on
    ffm-ffm--ns  same encoding, --ns (cross blocks only)
    fm-fm        all features in ONE field per side (reference fm encoders)
    fm-fm--ns    same, --ns
    mf-mf--ns    id-only encoding, --ns
    ffm-freq     ffm-ffm with --freq (frequency-weighted lambda)

this runs ``--seeds`` paired trials (dataset seed varies; each side trains
on the identical files) and accepts when for every metric

    |mean_ref - mean_ours| <= max(2*sigma_pair/sqrt(N), rtol*|mean_ref|, floor)

where sigma_pair is the std of the per-seed differences (paired design) and
floor absorbs quantization of tiny x100 metrics.

Usage:
    python scripts/parity_check.py [--seeds 5] [--rtol 0.15]
        [--variants ffm-ffm,fm-fm,...] [--users 2000] [--epochs 20]

Exit 0 on parity for every variant, 1 otherwise.  Markdown rows for
docs/PARITY.md are printed at the end.

Tiers (VERDICT r3 #3 — parity at the reference sweep's operating points):

    --tier toy    the round-2/3 gate: 2000 x 150, k=8, 20 epochs (default)
    --tier sweep  50k users x 5k items, zipf-1.0 skew, 100 epochs, N>=10
                  seeds, NO absolute floor, cells over the reference grid
                  (grid.sh: omega 2^0..2^-11, lambda {1,4,16}, k 16-64) via
                  --grid "k:lam:omega[;...]"; reports per-metric SIGN
                  consistency (a consistent one-sided delta across seeds is
                  flagged even when each cell passes the tolerance)
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, REPO)

METRICS = ["p@5", "p@10", "p@20", "ndcg@10", "ndcg@20", "ploss"]


def build_reference() -> str:
    binary = os.path.join(HERE, "ref_build", "train")
    if not os.path.exists(binary):
        subprocess.run([os.path.join(HERE, "build_reference.sh")], check=True)
    return binary


def last_metric_row(text: str):
    from one_class_ffm_tpu.logtools import parse_row

    row = None
    for ln in text.splitlines():
        r = parse_row(ln.strip())
        if r is not None and r.p:
            row = r
    return row


def row_metrics(row) -> dict:
    out = {}
    for K in (5, 10, 20, 40, 80):
        if K in row.p:
            out[f"p@{K}"] = row.p[K]
        if K in row.ndcg:
            out[f"ndcg@{K}"] = row.ndcg[K]
    if row.ploss is not None:
        out["ploss"] = row.ploss
    return out


def flatten_fields(rows, dims):
    """Re-encode multi-field rows as a single field with offset ids — the
    reference's fm encoding (all features in one field, kdd12.tools
    user_fm.py semantics)."""
    offs = [0]
    for d in dims[:-1]:
        offs.append(offs[-1] + d)
    out = []
    for labels, feats in rows:
        out.append((labels, [(0, offs[f] + i, v) for (f, i, v) in feats]))
    return out


def gen_variant(workdir: str, variant: str, users: int, items: int, seed: int,
                skew: float = 0.0):
    """Write item/train/va files for one variant; returns paths + extra CLI
    flags (shared verbatim by both trainers)."""
    import numpy as np

    from one_class_ffm_tpu.data.synth import SynthSpec, generate, _write_rows

    flags = []
    if variant in ("ffm-ffm", "ffm-ffm--ns", "ffm-freq"):
        spec = SynthSpec(n_users=users, n_items=items, avg_pos=6.0, seed=seed,
                         pop_skew=skew)
    elif variant in ("fm-fm", "fm-fm--ns"):
        spec = SynthSpec(n_users=users, n_items=items, avg_pos=6.0, seed=seed,
                         pop_skew=skew)
    elif variant == "mf-mf--ns":
        spec = SynthSpec(n_users=users, n_items=items, avg_pos=6.0, seed=seed,
                         fu=1, fv=1, pop_skew=skew)
    else:
        raise ValueError(variant)
    if variant.endswith("--ns") or variant == "mf-mf--ns":
        flags.append("--ns")
    if variant == "ffm-freq":
        flags.append("--freq")

    rng = np.random.default_rng(seed + 1)
    user_rows, item_rows = generate(spec)
    if variant.startswith("fm-"):
        du, dv = spec.resolve()
        user_rows = flatten_fields(user_rows, list(du))
        item_rows = flatten_fields(item_rows, list(dv))

    tr_rows, va_rows = [], []
    for labels, feats in user_rows:
        labels = list(labels)
        rng.shuffle(labels)
        n_va = int(len(labels) * 0.2)
        if len(labels) - n_va < 1:
            n_va = max(0, len(labels) - 1)
        va, tr = labels[:n_va], labels[n_va:]
        tr_rows.append((sorted(tr), feats))
        if va:
            va_rows.append((sorted(va), feats))
    item_path = os.path.join(workdir, "items.txt")
    train_path = os.path.join(workdir, "train.txt")
    va_path = os.path.join(workdir, "va.txt")
    _write_rows(item_path, item_rows, with_labels=False)
    _write_rows(train_path, tr_rows, with_labels=True)
    _write_rows(va_path, va_rows, with_labels=True)
    return item_path, train_path, va_path, flags


def _ref_cache_path(cache_dir, files, flags, epochs, k, lam, omega):
    """Cache key for a reference run: dataset content + every hyperparameter
    (the reference is deterministic per invocation — unseeded rand() — so
    one run per key is exactly reproducible)."""
    import hashlib

    h = hashlib.sha256()
    for p in files:
        with open(p, "rb") as fh:
            for chunk in iter(lambda: fh.read(1 << 20), b""):
                h.update(chunk)
    h.update(repr((sorted(flags), epochs, k, lam, omega)).encode())
    return os.path.join(cache_dir, f"ref_{h.hexdigest()[:24]}.json")


def run_pair(binary, files, flags, args, seed, k=None, lam=None, omega=None,
             card=None):
    item, train, va = files
    k = args.k if k is None else k
    lam = args.lam if lam is None else lam
    omega = args.omega if omega is None else omega
    hp = ["-k", str(k), "-l", str(lam), "-w", str(omega),
          "-r", "-1", "-t", str(args.epochs)]
    cache_file = None
    rm = None
    if args.ref_cache:
        os.makedirs(args.ref_cache, exist_ok=True)
        cache_file = _ref_cache_path(args.ref_cache, files, flags,
                                     args.epochs, k, lam, omega)
        if os.path.exists(cache_file):
            with open(cache_file) as fh:
                rm = json.load(fh)
    if rm is None:
        ref_cmd = [binary, *hp, "-c", "4", "-p", va, *flags, item, train]
        ref = subprocess.run(ref_cmd, capture_output=True, text=True)
        if ref.returncode != 0:
            raise RuntimeError(f"reference failed: {ref.stderr[-500:]}")
        r = last_metric_row(ref.stdout)
        if r is None:
            raise RuntimeError("missing reference metric row")
        rm = row_metrics(r)
        if cache_file:
            with open(cache_file, "w") as fh:
                json.dump(rm, fh)
    our_cmd = [sys.executable, "-m", "one_class_ffm_tpu", item, train,
               "-p", va, *hp, "--eval-every", str(args.epochs),
               "--seed", str(seed), "--platform", args.our_platform,
               "--dtype", args.our_dtype,
               "--cg-precond", args.our_cg, *flags]
    # one process per card: a JAX process reserves most of a GPU's memory
    env = dict(os.environ, CUDA_VISIBLE_DEVICES=card) if card else None
    ours = subprocess.run(our_cmd, capture_output=True, text=True,
                          cwd=REPO, env=env)
    if ours.returncode != 0:
        raise RuntimeError(f"ours failed: {ours.stderr[-500:]}")
    o = last_metric_row(ours.stdout)
    if o is None:
        raise RuntimeError("missing our metric row")
    return rm, row_metrics(o)


def mean_std(xs):
    n = len(xs)
    mu = sum(xs) / n
    var = sum((x - mu) ** 2 for x in xs) / max(n - 1, 1)
    return mu, math.sqrt(var)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tier", default="toy", choices=["toy", "sweep"],
                    help="preset: toy (round-2/3 gate) or sweep "
                         "(reference-grid operating points, VERDICT r3 #3)")
    ap.add_argument("--users", type=int, default=None)
    ap.add_argument("--items", type=int, default=None)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--omega", type=float, default=0.1)
    ap.add_argument("--lam", type=float, default=0.05)
    ap.add_argument("--seeds", type=int, default=None)
    ap.add_argument("--seed-offset", type=int, default=0,
                    help="first seed index (extend a salvaged partial run: "
                         "--seed-offset 8 --seeds 2 adds seeds 8..9; "
                         "combine logs with parity_summarize.py)")
    ap.add_argument("--ref-cache", default=None,
                    help="directory caching reference-run metrics by "
                         "dataset+hyperparameter hash — a second tier "
                         "(e.g. --our-dtype bfloat16) then skips every "
                         "reference re-run")
    ap.add_argument("--rtol", type=float, default=0.15)
    ap.add_argument("--skew", type=float, default=None,
                    help="zipf item-popularity exponent for the synthetic "
                         "data (sweep tier default 1.0)")
    ap.add_argument("--grid", default=None,
                    help="grid cells 'k:lam:omega[;k:lam:omega...]' — "
                         "default: the single (--k, --lam, --omega) cell "
                         "(toy) or three reference-grid cells (sweep)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="paired trials to run concurrently (each pair is "
                         "already multithreaded; keep modest).  With a GPU "
                         "--our-platform, capped at the visible cards: "
                         "each concurrent trial gets a card of its own")
    ap.add_argument("--our-dtype", default="float32",
                    choices=["float32", "float64", "bfloat16"],
                    help="storage dtype for OUR trainer (bf16 quality gate)")
    ap.add_argument("--our-cg", default="auto",
                    choices=["auto", "jacobi", "none"],
                    help="OUR trainer's --cg-precond (none = the "
                         "reference-exact plain CG — the k64 deficit "
                         "diagnosis arm)")
    ap.add_argument("--our-platform", default="cpu",
                    choices=["cpu", "gpu", "auto"],
                    help="platform for OUR trainer: cpu (default), gpu, or "
                         "auto (the GPU when one is visible)")
    ap.add_argument("--floor", type=float, default=None,
                    help="absolute tolerance floor on x100 metrics "
                         "(toy default 0.25; sweep default 0 — no floor)")
    ap.add_argument("--sign-rtol", type=float, default=0.05,
                    help="a metric whose per-seed deltas ALL share a sign "
                         "fails when |Δmean| exceeds this fraction of the "
                         "reference mean, even inside the noise tolerance")
    ap.add_argument("--variants", default=("ffm-ffm,ffm-ffm--ns,fm-fm,"
                                           "fm-fm--ns,mf-mf--ns,ffm-freq"))
    args = ap.parse_args()
    sweep = args.tier == "sweep"
    args.users = args.users or (50_000 if sweep else 2000)
    args.items = args.items or (5000 if sweep else 150)
    args.epochs = args.epochs or (100 if sweep else 20)
    args.seeds = args.seeds or (10 if sweep else 5)
    args.skew = args.skew if args.skew is not None else (1.0 if sweep else 0.0)
    args.floor = args.floor if args.floor is not None else (
        0.0 if sweep else 0.25)
    if args.grid:
        cells = [tuple(float(x) for x in c.split(":"))
                 for c in args.grid.split(";")]
        cells = [(int(k), lam, w) for k, lam, w in cells]
    elif sweep:
        # three reference-grid operating points (grid.sh:186,210 ranges):
        # the KDD12/Outbrain-style tiny omega at k=16, the KKBox-style
        # moderate omega at k=32 lambda=1, and the KKBox best row's
        # (k=64, lambda=4, omega=2^-5)
        cells = [(16, 4.0, 2.0 ** -11), (32, 1.0, 2.0 ** -5),
                 (64, 4.0, 2.0 ** -5)]
    else:
        cells = [(args.k, args.lam, args.omega)]

    import queue

    sys.path.insert(0, REPO)
    from one_class_ffm_tpu.platform import visible_gpus

    cards = [] if args.our_platform == "cpu" else visible_gpus()
    if cards:
        args.jobs = min(args.jobs, len(cards))
    card_pool = queue.Queue()
    for c in cards:
        card_pool.put(c)

    binary = build_reference()
    all_ok = True
    md_lines = []
    import concurrent.futures as cf
    for k, lam, omega in cells:
        cell_name = f"k={k} λ={lam:g} ω={omega:g}"
        for variant in args.variants.split(","):
            variant = variant.strip()

            def one(s):
                import time as _time

                t0 = _time.time()
                workdir = tempfile.mkdtemp(
                    prefix=f"parity_{variant}_{s}_")
                item, train, va, flags = gen_variant(
                    workdir, variant, args.users, args.items,
                    seed=1000 + s, skew=args.skew)
                card = card_pool.get() if cards else None
                try:
                    r, o = run_pair(binary, (item, train, va), flags, args,
                                    seed=s, k=k, lam=lam, omega=omega,
                                    card=card)
                finally:
                    if card is not None:
                        card_pool.put(card)
                # print as each pair lands — long runs stay salvageable
                print(f"[{cell_name} {variant} seed {s}] "
                      f"ref={json.dumps(r)}")
                print(f"[{cell_name} {variant} seed {s}] "
                      f"our={json.dumps(o)}  "
                      f"({_time.time() - t0:.0f}s)", flush=True)
                return r, o

            def one_safe(s):
                # one bad seed must not abort a multi-hour matrix run —
                # report it, fail the variant, keep the other seeds
                try:
                    return one(s)
                except Exception as e:  # noqa: BLE001
                    print(f"[{cell_name} {variant} seed {s}] "
                          f"FAILED: {e}", flush=True)
                    return None

            seed_range = range(args.seed_offset,
                               args.seed_offset + args.seeds)
            if args.jobs > 1:
                with cf.ThreadPoolExecutor(args.jobs) as ex:
                    results = list(ex.map(one_safe, seed_range))
            else:
                results = [one_safe(s) for s in seed_range]
            n_failed = sum(r is None for r in results)
            results = [r for r in results if r is not None]
            if not results:
                print(f"{cell_name} {variant}: PARITY FAILED "
                      f"(all {n_failed} trials errored)\n", flush=True)
                all_ok = False
                continue
            refs = [r for r, _ in results]
            ours = [o for _, o in results]

            print(f"\n== {cell_name} {variant}: mean over {len(results)} "
                  f"paired trials =="
                  + (f"  ({n_failed} trials ERRORED)" if n_failed else ""))
            print(f"{'metric':>8} {'ref mean±σ':>16} {'ours mean±σ':>16} "
                  f"{'Δmean':>8} {'tol':>8} {'sign':>6}")
            v_ok = True
            for m in METRICS:
                rv = [r[m] for r in refs if m in r]
                ov = [o[m] for o in ours if m in o]
                if not rv or not ov:
                    continue
                mu_r, sd_r = mean_std(rv)
                mu_o, sd_o = mean_std(ov)
                diffs = [o_ - r_ for r_, o_ in zip(rv, ov)]
                _, sd_d = mean_std(diffs)
                dm = abs(mu_o - mu_r)
                tol = max(2.0 * sd_d / math.sqrt(len(diffs)),
                          args.rtol * abs(mu_r), args.floor)
                n_pos = sum(1 for x in diffs if x > 0)
                n_neg = sum(1 for x in diffs if x < 0)
                one_sided = (n_pos == 0 or n_neg == 0) and len(diffs) >= 5
                # a consistent one-sided delta is a systematic quality
                # difference the noise tolerance can hide — fail it when
                # it exceeds sign_rtol of the reference level
                signed_bad = one_sided and dm > args.sign_rtol * abs(mu_r)
                ok = dm <= tol and not signed_bad
                v_ok &= ok
                sign = f"+{n_pos}/-{n_neg}"
                note = ("" if ok else
                        "  <-- ONE-SIDED" if signed_bad and dm <= tol
                        else "  <-- DIVERGED")
                print(f"{m:>8} {mu_r:8.3g}±{sd_r:<6.2g} "
                      f"{mu_o:8.3g}±{sd_o:<6.2g} "
                      f"{dm:8.3g} {tol:8.3g} {sign:>6}{note}")
                md_lines.append(
                    f"| {cell_name} | {variant} | {m} | "
                    f"{mu_r:.3g} ± {sd_r:.2g} | "
                    f"{mu_o:.3g} ± {sd_o:.2g} | {dm:.2g} | {tol:.2g} | "
                    f"{sign} | "
                    f"{'ok' if ok else 'ONE-SIDED' if signed_bad and dm <= tol else 'DIVERGED'} |"
                )
            v_ok &= n_failed == 0  # errored trials are never silently ok
            print(f"{cell_name} {variant}: "
                  f"{'PARITY OK' if v_ok else 'PARITY FAILED'}\n",
                  flush=True)
            all_ok &= v_ok

    print("\n--- markdown (docs/PARITY.md) ---")
    print("| cell | variant | metric | reference mean±σ | ours mean±σ | "
          "Δmean | tol | sign | verdict |")
    print("|---|---|---|---|---|---|---|---|---|")
    for ln in md_lines:
        print(ln)
    print("ALL PARITY OK" if all_ok else "PARITY FAILED")
    return 0 if all_ok else 1


if __name__ == "__main__":
    sys.exit(main())
