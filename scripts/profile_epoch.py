"""Epoch cost decomposition on the device.

Sweeps the CG iteration cap to split epoch time into fixed (gradient +
update + caches) vs per-CG-iteration cost:

    t(cap) ~= t_fixed + cap * t_iter        (early epochs run CG to the cap)

Prints one JSON line per cap, naming the device.

Usage: python scripts/profile_epoch.py  [BENCH_* env vars as bench.py]
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    n_users = int(os.environ.get("BENCH_USERS", 200_000))
    n_items = int(os.environ.get("BENCH_ITEMS", 20_000))
    k = int(os.environ.get("BENCH_K", 32))
    epochs = int(os.environ.get("BENCH_EPOCHS", 2))
    caps = [int(c) for c in os.environ.get("BENCH_CAPS", "0,1,5,20").split(",")]
    dtype_name = os.environ.get("BENCH_DTYPE", "float32")

    import jax
    import jax.numpy as jnp
    import numpy as np

    from one_class_ffm_tpu import platform
    from one_class_ffm_tpu.data.synth import SynthSpec, build_padded
    from one_class_ffm_tpu.models.blocks import BlockLayout
    from one_class_ffm_tpu.solver.jax_solver import FFMSolver, make_device_data
    from one_class_ffm_tpu.solver.params import HyperParams

    spec = SynthSpec(
        n_users=n_users, n_items=n_items, fu=2, fv=2,
        dims_u=(n_users, 1000), dims_v=(n_items, 500),
        avg_pos=5.0, seed=0,
    )
    (du, dv), u_pad, v_pad, y_pad = build_padded(
        spec, dtype=np.float32, row_multiple=256
    )
    layout = BlockLayout.make(du, dv, self_side=True)
    platform.enable_compile_cache()
    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    dtype = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype_name]

    for cap in caps:
        hp = HyperParams(k=k, lam=0.05, omega=0.1, r=-1.0, cg_max_iter=max(cap, 1))
        if cap == 0:
            # cap=0: cg_eps huge so CG exits immediately (0 hv calls is not
            # expressible; eps=1e9 stops after the while_loop cond -> 0 iters)
            hp = HyperParams(k=k, lam=0.05, omega=0.1, r=-1.0,
                             cg_max_iter=1, cg_eps=1e9)
        meta, data = make_device_data(
            u_pad, v_pad, y_pad, layout, hp, dtype=dtype,
            blocked_bm=int(os.environ.get("BENCH_BLOCKED_BM", 256)))
        solver = FFMSolver(meta, data)
        state = solver.init(jax.random.key(0))
        state = solver.epoch(state)  # warmup/compile
        jax.block_until_ready(state)
        t0 = time.perf_counter()
        for _ in range(epochs):
            state = solver.epoch(state)
        jax.block_until_ready(state)
        dt = (time.perf_counter() - t0) / epochs
        print(json.dumps({"cap": cap, "epoch_seconds": dt,
                          "examples_per_sec": n_users / dt,
                          "device": device}), flush=True)
        del solver, state, data
    return 0


if __name__ == "__main__":
    sys.exit(main())
