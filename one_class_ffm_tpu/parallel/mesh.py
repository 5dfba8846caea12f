"""Device-mesh sharding for the one-class FFM solver.

The reference parallelizes with OpenMP threads over rows on one shared-memory
machine (reference ffm.cpp:328,572,603,678,715 `#pragma omp parallel for`)
and has no distributed backend at all (SURVEY.md §2.4).  Here the same axis
of parallelism — rows (users m, items n) and the positive COO stream — is
sharded over a ``jax.sharding.Mesh`` ``data`` axis instead, and XLA/GSPMD
inserts the collectives the C++ never needed:

  * k x k Gram matrices (Q_c^T Q1 etc.) -> psum over shards (tiny payloads,
    ride the interconnect)
  * ``segment_sum`` by the *other* endpoint of a COO-sharded stream ->
    scatter-add + all-reduce
  * block tables W/H (D_f x k) -> replicated; per-table gradients all-reduce
    (a future ``model`` axis can row-shard very large tables)

The solver itself is unchanged: every op it uses (matmul, segment_sum,
gather) is GSPMD-partitionable, so sharding is pure data placement — the
same jitted epoch runs 1-device or N-device.

Multi-host: call ``jax.distributed.initialize()`` before ``make_mesh()``;
the mesh then spans all processes and each host feeds its addressable
shards (standard JAX multi-host SPMD).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: Optional[int] = None, axis: str = "data") -> Mesh:
    """1-D mesh over the first ``n_devices`` devices (default: all)."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def make_mesh2(
    n_data: int, n_model: int, axes: tuple = ("data", "model")
) -> Mesh:
    """2-D mesh: rows sharded over ``data``, large field tables row-sharded
    over ``model`` (the tensor-parallel analog for embedding tables whose
    feature dimension exceeds one device's HBM)."""
    devs = jax.devices()[: n_data * n_model]
    return Mesh(np.asarray(devs).reshape(n_data, n_model), axes)


def resolve_mesh(spec: Optional[str]) -> Optional[Mesh]:
    """Parse a CLI mesh spec into a Mesh (the product-surface analog of the
    reference's thread knob, train.cpp:174 omp_set_num_threads):

      None / ""  -> no mesh (single-device execution)
      "auto"     -> 1-D data mesh over every visible device
      "N"        -> 1-D data mesh over the first N devices
      "NxM"      -> 2-D mesh: N-way data axis x M-way model axis
    """
    if not spec:
        return None
    spec = spec.strip().lower()
    if spec == "auto":
        return make_mesh()
    if "x" in spec:
        nd, nm = (int(t) for t in spec.split("x", 1))
        if nm == 1:
            return make_mesh(nd)
        return make_mesh2(nd, nm)
    return make_mesh(int(spec))


def _put(tree, sharding):
    return jax.tree.map(lambda x: jax.device_put(x, sharding), tree)


def shard_data(data: Dict[str, Any], mesh: Mesh, axis: str = "data") -> Dict[str, Any]:
    """Place the problem arrays: rows and the COO stream sharded on ``axis``,
    small per-feature tables replicated.

    Requires padded row counts (u.m, v.m) and the padded nnz to be divisible
    by the mesh size (the data layer's ``row_multiple``/``nnz_multiple``
    guarantee this when set to a multiple of the device count).
    """
    row = NamedSharding(mesh, P(axis))
    rowT = NamedSharding(mesh, P(None, axis))  # transposed (p, rows) copies
    rep = NamedSharding(mesh, P())
    out = dict(data)
    for key in ("xu_idx", "xu_val", "xv_idx", "xv_val"):
        out[key] = tuple(_put(a, row) for a in data[key])
    for key in ("pos_u", "pos_v", "pos_w", "cnt_u", "cnt_v"):
        out[key] = _put(data[key], row)
    for key in ("reg_u", "reg_v", "colsq_u", "colsq_v"):
        if key in data:
            out[key] = tuple(
                None if a is None else _put(a, rep) for a in data[key])
    # the fused table kernels' transposed (p, rows) field copies: rows on
    # the trailing dim
    for key in ("xt_u", "xt_v"):
        if key in data:
            out[key] = tuple(
                None if pair is None else tuple(_put(a, rowT) for a in pair)
                for pair in data[key])
    # shard-aligned blocked layout (leading dim = blocks, nested in shards)
    for key in ("blk_u_take", "blk_u_src", "blk_u_own", "blk_u_w",
                "blk_u_srcg", "blk_u_from_v",
                "blk_v_take", "blk_v_src", "blk_v_own", "blk_v_w",
                "blk_v_from_u"):
        if key in data:
            out[key] = _put(data[key], row)
    # flat stream-keyed maps (original position -> slot): diagnostics /
    # refresh only
    for key in ("blk_u_inv", "blk_v_inv"):
        if key in data:
            out[key] = _put(data[key], row)
    # two-tier head tier (round 5): chunk-dim arrays shard on the leading
    # chunk dim when it divides evenly (nch_multiple pads it to the mesh
    # size), else replicate — the head ops run at jit level and GSPMD
    # partitions them either way; head-row feature copies (xh_*) are tiny
    # (NH bounded by the layout's 1/8-of-rows cap) and stay replicated.
    n_dev = mesh.shape[axis]
    for key in ("blk_u_hd_take", "blk_u_hd_src", "blk_u_hd_row",
                "blk_u_hd_loc", "blk_u_hd_w", "blk_u_hd_from_v",
                "blk_v_hd_take", "blk_v_hd_src", "blk_v_hd_row",
                "blk_v_hd_loc", "blk_v_hd_w", "blk_v_hd_from_u"):
        if key in data:
            a = data[key]
            out[key] = _put(a, row if a.shape[0] % n_dev == 0 else rep)
    for key in ("xh_u", "xh_v"):
        if key in data and data[key] is not None:
            out[key] = tuple(
                None if pair is None else tuple(_put(a, rep) for a in pair)
                for pair in data[key])
    return out


def replicate_params(params, mesh: Mesh):
    rep = NamedSharding(mesh, P())
    return _put(params, rep)


def shard_params_model(
    params,
    mesh: Mesh,
    min_rows: int = 4096,
    axis: str = "model",
):
    """Row-shard large block tables (D_f x k) over the ``model`` axis;
    small tables stay replicated.  GSPMD turns lookups/updates against the
    sharded tables into the necessary collectives (all-to-all / all-gather)
    — the SPMD equivalent of parameter-server style sharded embedding tables
    (SURVEY.md §2.4 TP row)."""
    if axis not in mesh.axis_names:
        return replicate_params(params, mesh)
    big = NamedSharding(mesh, P(axis, None))
    rep = NamedSharding(mesh, P())
    msize = mesh.shape[axis]
    out = {}
    for f12, blk in params.items():
        out[f12] = {}
        for name, t in blk.items():
            if t.shape[0] < min_rows:
                out[f12][name] = jax.device_put(t, rep)
                continue
            if t.shape[0] % msize != 0:
                raise ValueError(
                    f"table {name}[{f12}] has {t.shape[0]} rows, not divisible "
                    f"by model-axis size {msize}; create the solver with "
                    f"d_multiple={msize} (make_device_data) so table dims are "
                    f"padded for even sharding"
                )
            out[f12][name] = jax.device_put(t, big)
    return out


def shard_state(
    state: Dict[str, Any],
    mesh: Mesh,
    axis: str = "data",
    model_min_rows: Optional[int] = None,
) -> Dict[str, Any]:
    """Place solver state: P/Q/a/b/yt row-sharded; params replicated, or —
    when ``model_min_rows`` is set and the mesh has a ``model`` axis — large
    tables row-sharded over it."""
    row = NamedSharding(mesh, P(axis))
    out = dict(state)
    if model_min_rows is not None:
        out["params"] = shard_params_model(
            state["params"], mesh, min_rows=model_min_rows
        )
    else:
        out["params"] = replicate_params(state["params"], mesh)
    for key in ("P", "Q"):
        out[key] = {f12: _put(v, row) for f12, v in state[key].items()}
    for key in ("a", "b", "yt", "yt_u", "yt_v"):
        if key in state:
            out[key] = _put(state[key], row)
    rep = NamedSharding(mesh, P())
    n_dev = mesh.shape[axis]
    for key in ("yt_u_hd", "yt_v_hd"):  # carried head residuals (chunk dim)
        if key in state:
            a = state[key]
            out[key] = _put(a, row if a.shape[0] % n_dev == 0 else rep)
    return out
