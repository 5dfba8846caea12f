"""Non-interactive hyperparameter sweep runner (the grid.sh replacement).

The reference drives sweeps with interactive stdin menus emitting ``./train``
command lines run under ``xargs -P`` (reference script/grid.sh:256-331).
Here: a JSON spec -> the same grid (omega in powers of two, lambda, k,
variants) -> parallel subprocess jobs with the reference's exact log-path
contract (grid.sh:173-180,237):

    <log_root>/<name>.<k>[.te]/<variant>/<train_stem>.<lambda>.<omega>.<variant>

so the log tooling (logtools.py, or the reference's own scripts) works on the
output unchanged.  Improvements over grid.sh: resumable (complete logs are
skipped), machine-readable summary, no interactivity.

Note on ``jobs``: each job is an independent process with its own device
context.  CPU sweeps (``"extra_args": ["--platform", "cpu"]``) parallelize
freely.  On GPUs each job gets a card of its own through
``CUDA_VISIBLE_DEVICES`` and ``jobs`` is capped at the number of visible
cards: a JAX process reserves most of a card's memory, so a second process
on the same card fails.

Spec format (JSON):
{
  "name": "kkbox",            # dataset tag for the log dir
  "log_root": "logs",
  "k": [32],
  "te": false,                # .te suffix on the log dir (train-on-trva runs)
  "lambda": [1, 4, 16],
  "omega_pows": [0, -5, -11],   # omega = 2^pow   (or "omega": [0.1, ...])
  "epochs": 100,
  "eval_every": 10,
  "jobs": 2,
  "variants": [
    {"model": "ffm", "ns": true,
     "item": "items.ffm", "train": "tr.ffm", "test": "va.ffm"}
  ],
  "extra_args": ["--dtype", "float32"]
}
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


def variant_name(model: str, ns: bool) -> str:
    """grid.sh variant naming: <model>-<model>[--ns] (grid.sh:148-170)."""
    base = f"{model}-{model}"
    return base + ("--ns" if ns else "")


def omega_str(w: float) -> str:
    """Decimal formatting matching bash arithmetic output in grid.sh
    (e.g. 2^-5 -> '0.03125')."""
    s = f"{w:.17f}".rstrip("0")
    if s.endswith("."):
        s = s[:-1]
    return s if "." in s or "e" not in s else s


def log_path(
    log_root: str, name: str, k: int, te: bool, variant: str,
    train_path: str, lam: float, omega: float,
) -> str:
    d = f"{name}.{k}" + (".te" if te else "")
    stem = os.path.basename(train_path)
    lam_s = f"{lam:g}"
    return os.path.join(log_root, d, variant, f"{stem}.{lam_s}.{omega_str(omega)}.{variant}")


def is_complete(path: str, epochs: int, eval_every: int = 10) -> bool:
    """A job is complete when its .done marker exists (written by this
    runner on success), or — for logs produced outside the runner, e.g. by
    the reference — when the last row is the final evaluated epoch
    ((epochs // eval_every) * eval_every)."""
    if os.path.exists(path + ".done"):
        return True
    if not os.path.exists(path):
        return False
    last = ""
    with open(path) as fh:
        for ln in fh:
            if ln.strip():
                last = ln.strip()
    toks = last.split()
    final_eval = (epochs // max(eval_every, 1)) * max(eval_every, 1)
    return bool(toks) and toks[0] == str(final_eval) and final_eval > 0


@dataclass
class Job:
    cmd: List[str]
    log: str
    tag: str


def build_jobs(spec: Dict) -> List[Job]:
    name = spec["name"]
    log_root = spec.get("log_root", "logs")
    te = bool(spec.get("te", False))
    epochs = int(spec.get("epochs", 100))
    eval_every = int(spec.get("eval_every", 10))
    lambdas = spec.get("lambda", [1, 4, 16])
    if "omega" in spec:
        omegas = [float(w) for w in spec["omega"]]
    else:
        omegas = [2.0 ** p for p in spec.get("omega_pows", range(0, -12, -1))]
    extra = list(spec.get("extra_args", []))
    jobs: List[Job] = []
    for var in spec["variants"]:
        model = var["model"]
        ns = bool(var.get("ns", model == "mf"))
        vname = variant_name(model, ns)
        for k, lam, w in itertools.product(spec.get("k", [4]), lambdas, omegas):
            lp = log_path(log_root, name, k, te, vname, var["train"], lam, w)
            cmd = [
                sys.executable, "-m", "one_class_ffm_tpu",
                var["item"], var["train"],
                "-k", str(k), "-l", f"{lam:g}", "-w", f"{w:.17g}",
                "-r", str(spec.get("r", -1)),
                "-t", str(epochs), "--eval-every", str(eval_every),
            ]
            if var.get("test"):
                cmd += ["-p", var["test"]]
            if ns:
                cmd += ["--ns"]
            if var.get("freq"):
                cmd += ["--freq"]
            cmd += extra
            jobs.append(Job(cmd=cmd, log=lp, tag=os.path.basename(lp)))
    return jobs


def job_cards(spec: Dict, cards: Optional[List[str]] = None) -> List[str]:
    """The GPU ids the sweep hands out, one per running job: none for a CPU
    sweep, else ``cards`` (default: every visible GPU)."""
    extra = list(spec.get("extra_args", []))
    if "--platform" in extra and extra[extra.index("--platform") + 1:][:1] \
            == ["cpu"]:
        return []
    if cards is None:
        from .platform import visible_gpus

        cards = visible_gpus()
    return list(cards)


def run_sweep(
    spec: Dict, dry_run: bool = False, echo=print,
    cards: Optional[List[str]] = None,
) -> Tuple[int, int, int]:
    """Run all incomplete jobs with bounded parallelism.
    Returns (ran, skipped, failed).  ``cards``: GPU ids to pin jobs to
    (default: the visible GPUs; see job_cards)."""
    jobs = build_jobs(spec)
    epochs = int(spec.get("epochs", 100))
    eval_every = int(spec.get("eval_every", 10))
    n_jobs = int(spec.get("jobs", 1))
    free_cards = job_cards(spec, cards)
    if free_cards:
        n_jobs = min(n_jobs, len(free_cards))
    pending = []
    skipped = 0
    for j in jobs:
        if is_complete(j.log, epochs, eval_every):
            skipped += 1
            echo(f"skip (complete): {j.log}")
        else:
            pending.append(j)
    if dry_run:
        for j in pending:
            echo("would run: " + " ".join(j.cmd) + f" > {j.log}")
        return 0, skipped, 0

    running: List[Tuple[subprocess.Popen, Job, object, Optional[str]]] = []
    ran = failed = 0

    def reap(block: bool):
        """Process finished jobs.  block=True waits until at least one slot
        frees (NOT until all jobs finish — a slow job must not hold idle
        slots hostage, matching xargs -P semantics)."""
        nonlocal ran, failed
        while running:
            done = [t for t in running if t[0].poll() is not None]
            if done:
                for t in done:
                    proc, job, fh, card = t
                    fh.close()
                    running.remove(t)
                    if card is not None:
                        free_cards.append(card)
                    if proc.returncode == 0:
                        ran += 1
                        with open(job.log + ".done", "w") as mk:
                            mk.write("ok\n")
                        echo(f"done: {job.log}")
                    else:
                        failed += 1
                        echo(f"FAILED (rc={proc.returncode}): {job.log}")
                return
            if not block:
                return
            time.sleep(0.5)

    for j in pending:
        while len(running) >= n_jobs:
            reap(block=True)
        os.makedirs(os.path.dirname(j.log), exist_ok=True)
        fh = open(j.log, "w")
        card = free_cards.pop(0) if free_cards else None
        env = None
        if card is not None:
            env = dict(os.environ, CUDA_VISIBLE_DEVICES=card)
        proc = subprocess.Popen(j.cmd, stdout=fh, stderr=subprocess.STDOUT,
                                env=env)
        running.append((proc, j, fh, card))
        echo(f"start: {j.tag}" + (f" (gpu {card})" if card else ""))
    while running:
        reap(block=True)
    return ran, skipped, failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ocffm-sweep")
    ap.add_argument("spec", help="sweep spec JSON file")
    ap.add_argument("--dry-run", action="store_true")
    args = ap.parse_args(argv)
    with open(args.spec) as fh:
        spec = json.load(fh)
    ran, skipped, failed = run_sweep(spec, dry_run=args.dry_run)
    print(f"sweep: ran={ran} skipped={skipped} failed={failed}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
