"""Micro-benchmarks of the solver's table and positive-stream ops at the
headline shapes (bench.py's dataset: 200k users x 20k items, fields of dims
(200k, 1000) and (20k, 500), ~5 positives per user, k=32).

Times each op as its own jitted program (warm-up, then the mean of several
calls, ended by block_until_ready), at f32 and bf16:

  project_*        gather-FMA X W from a field table
  scatter_*        X^T Z by segment_sum (XLA scatter-add, f32 accumulation)
  pos_dot/pos_scatter   the COO positive-pass reductions

Prints one JSON line per op (milliseconds), each naming the device.

Usage: python scripts/op_bench.py
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def timed(fn, args, reps=20):
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def main() -> int:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from one_class_ffm_tpu import platform
    from one_class_ffm_tpu.data.synth import SynthSpec, build_padded
    from one_class_ffm_tpu.ops import sparse_ops as ops

    platform.enable_compile_cache()
    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    k = 32
    spec = SynthSpec(n_users=200_000, n_items=20_000, fu=2, fv=2,
                     dims_u=(200_000, 1000), dims_v=(20_000, 500),
                     avg_pos=5.0, seed=0)
    (du, dv), u_pad, v_pad, y_pad = build_padded(spec, row_multiple=256)
    rng = np.random.default_rng(0)

    def rec(name, dt, fn, args):
        ms = timed(jax.jit(fn), args) * 1e3
        print(json.dumps({"op": name, "dtype": jnp.dtype(dt).name,
                          "ms": ms, "device": device}), flush=True)

    for dt in (jnp.float32, jnp.bfloat16):
        with platform.precision_scope(dt):
            for side, pf, d in (("u", u_pad, du[1]), ("v", v_pad, dv[1])):
                idx = jnp.asarray(pf.idx[1])
                val = jnp.asarray(pf.val[1], dt)
                W = jnp.asarray(rng.normal(size=(d, k)), dt)
                Z = jnp.asarray(rng.normal(size=(pf.m, k)), dt)
                rec(f"project_{side}_D{d}", dt, ops.project, (idx, val, W))
                rec(f"scatter_{side}_D{d}", dt,
                    lambda i, v, z, d=d: ops.scatter(i, v, z, d),
                    (idx, val, Z))
            A = jnp.asarray(rng.normal(size=(u_pad.m, k)), dt)
            B = jnp.asarray(rng.normal(size=(v_pad.m, k)), dt)
            u, v = jnp.asarray(y_pad.u), jnp.asarray(y_pad.v)
            w = jnp.asarray(y_pad.w, dt)
            rec("pos_dot", dt, ops.pos_dot, (A, u, B, v))
            rec("pos_scatter_to_users", dt,
                lambda ww, b, t, s: ops.pos_scatter(ww, b, t, s, u_pad.m,
                                                    seg_sorted=True),
                (w, B, v, u))
            rec("pos_scatter_to_items", dt,
                lambda ww, a, t, s: ops.pos_scatter(ww, a, t, s, v_pad.m),
                (w, A, u, v))
    return 0


if __name__ == "__main__":
    sys.exit(main())
