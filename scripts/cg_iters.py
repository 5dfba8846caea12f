"""On-device CG iteration counts + epoch times at bench shapes.

For each cg_precond mode: compile epoch_stats once, run N epochs from a
fresh init, print the per-solve iteration vector and the epoch time.
Decides whether a preconditioner's iteration savings beat its diag-build
cost at real scale (the CPU probe only shows toy-scale behavior).
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def main():
    n_users = int(os.environ.get("BENCH_USERS", 200_000))
    n_items = int(os.environ.get("BENCH_ITEMS", 20_000))
    k = int(os.environ.get("BENCH_K", 32))
    epochs = int(os.environ.get("BENCH_EPOCHS", 4))
    dtype = (jnp.bfloat16 if os.environ.get("BENCH_DTYPE", "bfloat16")
             == "bfloat16" else jnp.float32)

    from one_class_ffm_tpu.data.synth import SynthSpec, build_padded
    from one_class_ffm_tpu.models.blocks import BlockLayout
    from one_class_ffm_tpu.solver.jax_solver import FFMSolver, make_device_data
    from one_class_ffm_tpu.solver.params import HyperParams

    spec = SynthSpec(n_users=n_users, n_items=n_items, fu=2, fv=2,
                     dims_u=(n_users, 1000), dims_v=(n_items, 500),
                     avg_pos=5.0, seed=0)
    (du, dv), u_pad, v_pad, y_pad = build_padded(spec, dtype=np.float32,
                                                 row_multiple=256)
    layout = BlockLayout.make(du, dv, self_side=True)

    blocked_bm = int(os.environ.get("BENCH_BLOCKED_BM", 256))
    for mode in ("jacobi", "none"):
        hp = HyperParams(k=k, lam=0.05, omega=0.1, r=-1.0, cg_precond=mode)
        meta, data = make_device_data(u_pad, v_pad, y_pad, layout, hp,
                                      dtype=dtype, blocked_bm=blocked_bm)
        solver = FFMSolver(meta, data)
        state = solver.init(jax.random.key(0))
        state, its = solver.epoch_stats(state)  # compile + warmup epoch
        jax.block_until_ready(state)
        print(f"[{mode}] warmup iters={np.asarray(its).tolist()}", flush=True)
        for ep in range(epochs):
            t0 = time.perf_counter()
            state, its = solver.epoch_stats(state)
            its_host = np.asarray(its)  # sync
            jax.block_until_ready(state)
            dt = time.perf_counter() - t0
            print(f"[{mode}] epoch {ep}: {dt*1e3:7.1f} ms "
                  f"iters={its_host.tolist()} total={int(its_host.sum())}",
                  flush=True)


if __name__ == "__main__":
    main()
