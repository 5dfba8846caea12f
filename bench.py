"""Benchmark: one-class FFM training throughput on the current device.

Prints ONE JSON line:
  {"metric": "examples_per_sec_per_chip_k32", "value": N,
   "unit": "examples/s", "vs_baseline": R}

"examples" = training rows (users) swept per alternating Gauss-Newton epoch
(every field-pair block: gradient + CG-capped-20 + Newton update), at k=32 on
a synthetic FFM dataset (2 user fields x 2 item fields, ~5 positives/user) —
the headline configuration.  vs_baseline compares against the C++
reference binary's measured examples/s on the same data when
``scripts/reference_baseline.json`` exists, else 1.0.  The line names the
device (platform, kind, count) it was measured on.
"""

from __future__ import annotations

import json
import os
import sys
import time


def main() -> int:
    n_users = int(os.environ.get("BENCH_USERS", 200_000))
    n_items = int(os.environ.get("BENCH_ITEMS", 20_000))
    k = int(os.environ.get("BENCH_K", 32))
    epochs = int(os.environ.get("BENCH_EPOCHS", 4))
    dtype_name = os.environ.get("BENCH_DTYPE", "auto")

    import jax
    import jax.numpy as jnp
    import numpy as np

    from one_class_ffm_tpu.data.synth import SynthSpec, build_padded
    from one_class_ffm_tpu.models.blocks import BlockLayout
    from one_class_ffm_tpu.solver.jax_solver import FFMSolver, make_device_data
    from one_class_ffm_tpu.solver.params import HyperParams

    spec = SynthSpec(
        n_users=n_users,
        n_items=n_items,
        fu=2,
        fv=2,
        dims_u=(n_users, 1000),
        dims_v=(n_items, 500),
        avg_pos=5.0,
        seed=0,
        pop_skew=float(os.environ.get("BENCH_SKEW", 0.0)),
    )
    # rows padded to 256 so the blocked layout's row blocks divide
    (du, dv), u_pad, v_pad, y_pad = build_padded(
        spec, dtype=np.float32, row_multiple=256
    )
    layout = BlockLayout.make(du, dv, self_side=True)
    hp = HyperParams(k=k, lam=0.05, omega=0.1, r=-1.0,
                     cg_precond=os.environ.get("BENCH_CG_PRECOND", "auto"))
    from one_class_ffm_tpu import platform

    platform.enable_compile_cache()
    if dtype_name == "auto":
        dtype_name = platform.default_dtype()
    dtype = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype_name]
    meta, data = make_device_data(
        u_pad, v_pad, y_pad, layout, hp, dtype=dtype,
        blocked_bm=int(os.environ.get("BENCH_BLOCKED_BM", 256)))
    solver = FFMSolver(meta, data)
    state = solver.init(jax.random.key(0))

    f12_0 = meta.layout.all_blocks()[0].f12
    w_init = np.asarray(state["params"][f12_0]["W"])

    # Timing protocol: epochs 2..epochs+1 from a fresh init; epoch 1
    # compiles.  Early epochs do the full CG work (up to 20 iterations per
    # block table); once the model converges CG exits after ~1 iteration
    # and an epoch costs ~20x less, so timing converged epochs would
    # overstate throughput.
    state = solver.epoch(state)
    jax.block_until_ready(state)
    t0 = time.perf_counter()
    for _ in range(epochs):
        state = solver.epoch(state)
    jax.block_until_ready(state)
    dt = time.perf_counter() - t0

    # guard: the timed work must be real optimization, not a degenerate
    # graph — parameters moved, every residual is finite
    w_now = np.asarray(state["params"][f12_0]["W"])
    assert np.all(np.isfinite(w_now)) and not np.allclose(w_now, w_init)
    assert np.all(np.isfinite(np.asarray(state[solver.yt_key])))

    eps = n_users * epochs / dt

    vs = 1.0
    base_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "scripts", "reference_baseline.json")
    if os.path.exists(base_path):
        with open(base_path) as fh:
            base = json.load(fh)
        ref_eps = base.get("examples_per_sec")
        if ref_eps:
            vs = eps / ref_eps

    print(
        json.dumps(
            {
                "metric": "examples_per_sec_per_chip_k32",
                "value": eps,
                "unit": "examples/s",
                "vs_baseline": vs,
                "dtype": dtype_name,
                "epoch_seconds": dt / epochs,
                "peak_bytes_in_use": (jax.devices()[0].memory_stats()
                                      or {}).get("peak_bytes_in_use"),
                "device": {"platform": jax.devices()[0].platform,
                           "kind": jax.devices()[0].device_kind,
                           "count": len(jax.devices())},
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
