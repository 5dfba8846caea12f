"""Orbax-backed native checkpoints (sharded, async-capable).

The npz checkpoints in train.py are the simple single-host format; this is
the sharding-native one: the params pytree is saved with its shardings through
orbax, so multi-host sharded tables restore without gathering to one host.
Both formats carry the same metadata (epoch, layout) and are
interchangeable through the Trainer.

Kept separate from train.py so environments without orbax still train.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple


def available() -> bool:
    try:
        import orbax.checkpoint  # noqa: F401

        return True
    except Exception:
        return False


def save(
    ckpt_dir: str,
    params,
    epoch: int,
    meta: Optional[Dict[str, Any]] = None,
) -> None:
    """Save the params pytree (with shardings) + metadata under ckpt_dir."""
    import orbax.checkpoint as ocp

    path = os.path.abspath(os.path.join(ckpt_dir, f"step_{epoch}"))
    # string keys: orbax pytree paths must be strings
    tree = {str(f12): blk for f12, blk in params.items()}
    with ocp.PyTreeCheckpointer() as ckptr:
        ckptr.save(path, tree, force=True)
    with open(os.path.join(ckpt_dir, "orbax_meta.json"), "w") as fh:
        json.dump(dict(epoch=epoch, step_dir=f"step_{epoch}", **(meta or {})), fh)


def load(ckpt_dir: str, shardings=None) -> Tuple[Dict[int, Any], int]:
    """Restore (params, epoch); pass ``shardings`` (same pytree structure of
    jax.sharding.Sharding) to restore directly onto a mesh."""
    import jax
    import numpy as np
    import orbax.checkpoint as ocp

    with open(os.path.join(ckpt_dir, "orbax_meta.json")) as fh:
        meta = json.load(fh)
    path = os.path.abspath(os.path.join(ckpt_dir, meta["step_dir"]))
    with ocp.PyTreeCheckpointer() as ckptr:
        if shardings is not None:
            stree = {str(f12): blk for f12, blk in shardings.items()}
            restore_args = jax.tree.map(
                lambda s: ocp.ArrayRestoreArgs(sharding=s), stree
            )
            tree = ckptr.restore(path, restore_args=restore_args)
        else:
            # restore as host numpy: device/topology-independent (a
            # checkpoint written on a GPU must restore on the CPU and vice versa)
            meta_tree = ckptr.metadata(path).item_metadata
            restore_args = jax.tree.map(
                lambda _: ocp.RestoreArgs(restore_type=np.ndarray), meta_tree
            )
            tree = ckptr.restore(path, restore_args=restore_args)
    params = {int(k): v for k, v in tree.items()}
    return params, int(meta["epoch"])


def has_checkpoint(ckpt_dir: str) -> bool:
    return os.path.exists(os.path.join(ckpt_dir, "orbax_meta.json"))
