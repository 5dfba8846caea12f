"""Serving-path throughput: full-catalog scoring + top-K.

Times ``reps`` full passes after a warm-up and reports the mean.  Prints one
JSON line: users/s against the catalog and pair-scores/s, naming the device.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    n_users = int(os.environ.get("SB_USERS", 200_704))
    n_items = int(os.environ.get("SB_ITEMS", 20_224))
    k = int(os.environ.get("SB_K", 32))
    chunk = int(os.environ.get("SB_CHUNK", 4096))
    topk = int(os.environ.get("SB_TOPK", 10))
    reps = int(os.environ.get("SB_REPS", 3))

    import jax
    import jax.numpy as jnp
    import numpy as np

    from one_class_ffm_tpu import platform

    platform.enable_compile_cache()
    rng = np.random.default_rng(0)
    dt = jnp.dtype(platform.default_dtype())
    # two cross blocks, as in the bench config
    P1 = jnp.asarray(rng.normal(size=(n_users, k)), dt)
    P2 = jnp.asarray(rng.normal(size=(n_users, k)), dt)
    Q1 = jnp.asarray(rng.normal(size=(n_items, k)), dt)
    Q2 = jnp.asarray(rng.normal(size=(n_items, k)), dt)
    bt = jnp.asarray(rng.normal(size=(n_items,)), dt)

    @jax.jit
    def score_all(P1, P2, Q1, Q2, bt):
        def body(c, acc):
            s1 = jax.lax.dynamic_slice(P1, (c * chunk, 0), (chunk, k))
            s2 = jax.lax.dynamic_slice(P2, (c * chunk, 0), (chunk, k))
            z = s1 @ Q1.T + s2 @ Q2.T + bt[None, :]
            _, idx = jax.lax.top_k(z, topk)
            return jax.lax.dynamic_update_slice(acc, idx, (c * chunk, 0))

        out = jnp.zeros((n_users, topk), jnp.int32)
        return jax.lax.fori_loop(0, n_users // chunk, body, out)

    jax.block_until_ready(score_all(P1, P2, Q1, Q2, bt))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = score_all(P1, P2, Q1, Q2, bt)
    jax.block_until_ready(out)
    dtm = (time.perf_counter() - t0) / reps
    dev = jax.devices()[0]
    print(json.dumps({
        "metric": "serving_users_per_sec",
        "value": n_users / dtm,
        "catalog": n_items,
        "pair_scores_per_sec": n_users * n_items / dtm,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
