"""Smoke check of the trainer on an NVIDIA GPU, through its own entry points.

    python chip_smoke.py                one card: phases (a)-(d)
    python chip_smoke.py --four-cards   the mesh path on four cards only

Phases (one card):
  (a) device: what JAX sees, the card's byte limit, name and power limit.
  (b) op parity with the fp64 oracle at oracle size (f32): every block's
      gradient, Hessian-vector product and the objective.
  (c) the headline width (200k users x 20k items, 2+2 fields of dims
      (200k, 1000) and (20k, 500), ~5 positives per user, k=32): one
      gradient and one Hv per half-solve on the GPU against the same jitted
      functions on the CPU backend (f32).
  (d) the CLI end to end on a synthetic dataset written from --seed at the
      headline width: 3 epochs at the default dtype, eval every epoch, text
      model, top-10 per test user.

--four-cards: --mesh 4 and --mesh 2x2 on the headline: one gradient and one
Hv per half-solve against the one-card result (f32), arrays checked to hold
shards on all four cards, then 2 CLI epochs with --eval-shard items.

Tolerance, max|got - ref| / max|ref| per array: 1e-4 against the oracle
and across devices at f32.  Float32 matmul precision keeps about 1e-6;
TF32 (about 1e-3) or a wrong term fails it.  Across devices only the order
of the sums differs (about 1M positives).

Any failure exits non-zero; the last line of a passing run is one JSON
object naming the device.  There is no fallback to the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

TOL_F32 = 1e-4
HEADLINE = dict(n_users=200_000, n_items=20_000, fu=2, fv=2,
                dims_u=(200_000, 1000), dims_v=(20_000, 500), avg_pos=5.0)
K = 32


class SmokeFailure(AssertionError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def rel_err(got, ref) -> float:
    import numpy as np

    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    scale = max(float(np.max(np.abs(ref))), 1e-30)
    return float(np.max(np.abs(got - ref))) / scale


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


# -- (a) ---------------------------------------------------------------------


def phase_device(n_cards: int):
    import jax

    devs = jax.devices()
    print(f"(a) jax {jax.__version__} devices: {devs}")
    check(devs[0].platform == "gpu",
          f"no GPU: JAX runs on {devs[0].platform!r}")
    check(len(devs) >= n_cards,
          f"{n_cards} cards needed, JAX sees {len(devs)}")
    for d in devs[:n_cards]:
        limit = (d.memory_stats() or {}).get("bytes_limit")
        print(f"(a) {d}: kind={d.device_kind} bytes_limit={limit}")
        check(bool(limit), f"{d} reports no bytes_limit")
    card = card_line()
    print(f"(a) card (name, power limit): {card}")
    return devs[0], card


# -- shared builders ---------------------------------------------------------


def headline_problem(dtype):
    """The headline problem on the default device (bench.py's config)."""
    import numpy as np

    from one_class_ffm_tpu.data.synth import SynthSpec, build_padded
    from one_class_ffm_tpu.models.blocks import BlockLayout
    from one_class_ffm_tpu.solver.jax_solver import make_device_data
    from one_class_ffm_tpu.solver.params import HyperParams

    spec = SynthSpec(seed=0, **HEADLINE)
    (du, dv), u_pad, v_pad, y_pad = build_padded(
        spec, dtype=np.float32, row_multiple=256)
    layout = BlockLayout.make(du, dv, self_side=True)
    hp = HyperParams(k=K, lam=0.05, omega=0.1, r=-1.0)
    return make_device_data(u_pad, v_pad, y_pad, layout, hp, dtype=dtype,
                            blocked_bm=256)


def compare_grad_hv(got: dict, ref: dict, tol: float, tag: str,
                    dims: dict = None) -> float:
    """Worst relative error over every half-solve's (G, Hv(G))."""
    worst = 0.0
    for key in sorted(ref):
        for name, a, b in (("G", got[key][0], ref[key][0]),
                           ("Hv", got[key][1], ref[key][1])):
            d = (dims or {}).get(key)
            if d is not None:
                a, b = a[:d], b[:d]
            e = rel_err(a, b)
            worst = max(worst, e)
            check(math.isfinite(e) and e <= tol,
                  f"{tag} {name}[{key}] rel err {e:.3g} > {tol:g}")
    return worst


# -- (b) ---------------------------------------------------------------------


def phase_oracle():
    import jax.numpy as jnp
    import numpy as np

    from one_class_ffm_tpu.solver import oracle
    from one_class_ffm_tpu.solver.jax_solver import FFMSolver

    configs = [dict(), dict(self_side=False), dict(freq=True),
               dict(cg_precond="jacobi")]
    for i, cfg in enumerate(configs):
        rng = np.random.default_rng(100 + i)
        kw = dict(cg_precond="none")
        kw.update(cfg)
        prob, params = oracle.make_problem(
            rng, m=64, n=32, Du=(64, 12), Dv=(32, 9), k=16, density=0.15,
            **kw)
        meta, data = oracle.to_device_problem(
            prob, dtype=np.float32, multiple=16, blocked_bm=16)
        solver = FFMSolver(meta, data)
        state = solver.refresh_caches(
            {"params": oracle.oracle_params_to_jax(params, jnp.float32)})
        got = solver.grad_hv(state)
        worst = 0.0
        for b in meta.layout.epoch_order():
            for first in (True, False):
                key = f"{b.f12}{'W' if first else 'H'}"
                G_ref, hv_ref = oracle.grad_and_hv(prob, params, b, first)
                d = b.d1 if first else b.d2
                G = np.asarray(got[key][0], np.float64)[:d]
                e_g = rel_err(G, G_ref)
                e_h = rel_err(np.asarray(got[key][1], np.float64)[:d],
                              hv_ref(G))
                worst = max(worst, e_g, e_h)
                check(e_g <= TOL_F32 and e_h <= TOL_F32,
                      f"(b) {cfg} block {key}: grad {e_g:.3g} "
                      f"hv {e_h:.3g} > {TOL_F32:g}")
        e_o = rel_err(float(solver.objective(state)),
                      oracle.objective(prob, params))
        check(e_o <= TOL_F32, f"(b) {cfg} objective rel err {e_o:.3g}")
        print(f"(b) oracle {cfg or 'ffm'}: blocked={meta.blocked_bm_u}/"
              f"{meta.blocked_bm_v} worst "
              f"grad/hv rel err {worst:.2e}, objective {e_o:.2e} "
              f"(tol {TOL_F32:g})")


# -- (c) ---------------------------------------------------------------------


def phase_headline_cpu():
    import jax
    import jax.numpy as jnp

    from one_class_ffm_tpu.solver.jax_solver import FFMSolver

    meta, data = headline_problem(jnp.float32)
    solver = FFMSolver(meta, data)
    state = solver.init(jax.random.key(0))
    t0 = time.perf_counter()
    got = jax.device_get(solver.grad_hv(state))
    t_gpu = time.perf_counter() - t0
    params = jax.device_get(state["params"])
    del state, data, solver
    print(f"(c) headline f32 on the GPU: blocked={meta.blocked_bm_u}/"
          f"{meta.blocked_bm_v} grad+hv of {len(got)} half-solves in "
          f"{t_gpu:.1f} s (compile included)")
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        meta_c, data_c = headline_problem(jnp.float32)
        solver_c = FFMSolver(meta_c, data_c)
        state_c = solver_c.refresh_caches(
            {"params": jax.device_put(params, cpu)})
        t0 = time.perf_counter()
        ref = jax.device_get(solver_c.grad_hv(state_c))
        t_cpu = time.perf_counter() - t0
    worst = compare_grad_hv(got, ref, TOL_F32, "(c)")
    print(f"(c) GPU vs CPU backend (CPU {t_cpu:.1f} s): worst rel err "
          f"{worst:.2e} (tol {TOL_F32:g})")


# -- (d) ---------------------------------------------------------------------


def write_headline_dataset(work: str, seed: int):
    from one_class_ffm_tpu.data.synth import SynthSpec, write_dataset

    t0 = time.perf_counter()
    paths = write_dataset(os.path.join(work, "data"),
                          SynthSpec(seed=seed, **HEADLINE))
    print(f"(d) dataset written from seed {seed} in "
          f"{time.perf_counter() - t0:.1f} s")
    return paths


def run_cli(argv):
    """The CLI in this process (one JAX process holds the card); returns
    (rc, stdout)."""
    from one_class_ffm_tpu.cli import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def check_cli_output(out: str, jsonl: str, epochs: int, tag: str):
    rows = [ln for ln in out.splitlines()
            if ln.strip() and ln.split()[0].isdigit() and "(" in ln]
    check(len(rows) == epochs, f"{tag} {len(rows)} metric rows, "
          f"expected {epochs}")
    recs = [json.loads(ln) for ln in open(jsonl)]
    check(len(recs) == epochs, f"{tag} {len(recs)} jsonl records")
    for r in recs:
        bad = [k for k, v in r.items() if not math.isfinite(float(v))]
        check(not bad, f"{tag} non-finite metrics at epoch {r['epoch']}: "
              f"{bad}")
    return rows, recs


def phase_cli(work: str, seed: int, card: str, paths):
    item, train, va = paths
    model = os.path.join(work, "model.txt")
    jsonl = os.path.join(work, "metrics.jsonl")
    t0 = time.perf_counter()
    rc, out = run_cli([item, train, "-p", va, "-k", str(K), "-t", "3",
                       "--eval-every", "1", "-o", model,
                       "--predict-topk", "10", "--jsonl", jsonl,
                       "--seed", str(seed)])
    wall = time.perf_counter() - t0
    check(rc == 0, f"(d) CLI exit code {rc}")
    rows, recs = check_cli_output(out, jsonl, 3, "(d)")
    for ln in rows:
        print(f"(d) {ln}")
    check(os.path.getsize(model) > 0, "(d) empty model file")
    top = [ln for ln in out.splitlines()
           if ln.count(",") == 9 and ln.replace(",", "").isdigit()]
    check(len(top) > 0, "(d) no top-K rows")
    print(f"(d) model file {os.path.getsize(model)} bytes; {len(top)} "
          f"top-10 rows, first: {top[0]}")
    e23 = sum(r["epoch_seconds"] for r in recs if r["epoch"] in (2, 3))
    print(f"(d) epochs 2-3 wall {e23:.3f} s "
          f"({2 * HEADLINE['n_users'] / e23:.1f} users/s) on {card}; "
          f"whole CLI run {wall:.1f} s")


# -- --four-cards --------------------------------------------------------------


def phase_four_cards(work: str, seed: int, card: str):
    import jax
    import jax.numpy as jnp

    from one_class_ffm_tpu.train import TrainConfig, Trainer

    paths = write_headline_dataset(work, seed)
    item, train, va = paths

    def trainer(mesh):
        cfg = TrainConfig(item_path=item, train_path=train, test_path=va,
                          k=K, lam=0.05, omega=0.1, dtype="float32",
                          mesh_shape=mesh, seed=seed)
        return Trainer(cfg)

    ref_tr = trainer(None)
    ref_tr.init_state()
    params = ref_tr.params_numpy()
    ref = jax.device_get(ref_tr.solver.grad_hv(ref_tr.state))
    dims = {}
    for b in ref_tr.data.layout.all_blocks():
        dims[f"{b.f12}W"], dims[f"{b.f12}H"] = b.d1, b.d2
    del ref_tr
    for mesh in ("4", "2x2"):
        tr = trainer(mesh)
        st = tr.solver.refresh_caches({"params": {
            f12: {n: jnp.asarray(tr._pad_table(t), jnp.float32)
                  for n, t in blk.items()}
            for f12, blk in params.items()}})
        tr.state = tr._place_state(st)
        got = jax.device_get(tr.solver.grad_hv(tr.state))
        worst = compare_grad_hv(got, ref, TOL_F32, f"(4) mesh {mesh}", dims)
        on = set()
        for name, arr in (("P", next(iter(tr.state["P"].values()))),
                          ("pos_u", tr.solver.data["pos_u"]),
                          ("yt", tr.state[tr.solver.yt_key])):
            devs = arr.sharding.device_set
            shard_rows = {s.data.shape[0] for s in arr.addressable_shards}
            check(len(devs) == 4 and max(shard_rows) < arr.shape[0],
                  f"(4) mesh {mesh}: {name} is not sharded over 4 cards "
                  f"({len(devs)} devices, shard rows {shard_rows})")
            on |= {d.id for d in devs}
        print(f"(4) mesh {mesh}: blocked_shards={tr.meta.blocked_shards} "
              f"carry={tr.solver.blk_yt}; grad+hv vs one card worst rel "
              f"err {worst:.2e} (tol {TOL_F32:g}); state and data sharded "
              f"over devices {sorted(on)}")
        del tr, st, got
    for mesh in ("4", "2x2"):
        jsonl = os.path.join(work, f"metrics_{mesh}.jsonl")
        t0 = time.perf_counter()
        rc, out = run_cli([item, train, "-p", va, "-k", str(K), "-t", "2",
                           "--eval-every", "1", "--mesh", mesh,
                           "--eval-shard", "items", "--jsonl", jsonl,
                           "--seed", str(seed)])
        check(rc == 0, f"(4) CLI --mesh {mesh} exit code {rc}")
        rows, recs = check_cli_output(out, jsonl, 2, f"(4) CLI mesh {mesh}")
        for ln in rows:
            print(f"(4) CLI --mesh {mesh}: {ln}")
        print(f"(4) CLI --mesh {mesh}: epoch 2 "
              f"{recs[1]['epoch_seconds']:.3f} s, run "
              f"{time.perf_counter() - t0:.1f} s on 4x {card}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card mesh path and its "
                         "one-card reference")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import jax

    from one_class_ffm_tpu import platform

    platform.enable_compile_cache()
    n_cards = 4 if args.four_cards else 1
    work = os.path.join(REPO, ".chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        dev, card = phase_device(n_cards)
        if args.four_cards:
            phase_four_cards(work, args.seed, card)
        else:
            phase_oracle()
            phase_headline_cpu()
            phase_cli(work, args.seed, card, write_headline_dataset(
                work, args.seed))
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
