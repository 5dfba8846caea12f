"""Multi-host distributed initialization.

The reference has no distributed backend at all (SURVEY.md §2.4: OpenMP on
one shared-memory machine).  This is the communication layer:
``jax.distributed`` for process bootstrap, then the same ``data``-axis mesh
spanning every host's devices — XLA hands the collectives to NCCL.

Typical multi-host entry:

    from one_class_ffm_tpu.parallel.distributed import init_distributed
    init_distributed()                # no-op single-process
    mesh = make_mesh()               # spans all processes' devices
    ...                              # each host feeds its addressable shards
"""

from __future__ import annotations

import os
from typing import Optional


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialize jax.distributed when running multi-process.

    With no arguments, uses the env vars JAX_COORDINATOR_ADDRESS /
    JAX_NUM_PROCESSES / JAX_PROCESS_ID; nothing discovers a cluster on its
    own.  Returns True when multi-process mode is active, False when
    single-process (in which case nothing is initialized).
    """
    import jax

    env_addr = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    env_np = num_processes or _int_env("JAX_NUM_PROCESSES")
    env_pid = process_id if process_id is not None else _int_env("JAX_PROCESS_ID")

    if not env_addr:
        return False
    if env_np is not None and env_np <= 1:
        return False
    try:
        jax.distributed.initialize(
            coordinator_address=env_addr,
            num_processes=env_np,
            process_id=env_pid,
        )
        return jax.process_count() > 1
    except RuntimeError:
        # already initialized
        return False


def _int_env(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v else None


def process_local_slice(global_rows: int) -> slice:
    """The row range this process should feed when data is sharded over the
    ``data`` axis of a mesh spanning all processes (rows must be padded to a
    multiple of the global device count)."""
    import jax

    n_proc = jax.process_count()
    pid = jax.process_index()
    per = global_rows // n_proc
    return slice(pid * per, (pid + 1) * per)
