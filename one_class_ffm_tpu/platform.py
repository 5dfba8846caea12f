"""The one place that decides which device the program runs on, and what
follows from it.

* ``backend()``: ``"cpu"`` or ``"gpu"``; any other JAX backend is an error.
* ``select(name)``: the ``--platform`` flag (``auto|cpu|gpu``).  A platform
  that was asked for and is not there is an error, never a silent fallback.
* ``DEFAULT_DTYPE``: the storage dtype that ``--dtype auto`` means on each
  platform (f32 on the CPU, bf16 on the GPU, where the positive passes are
  bandwidth-bound and bf16 halves their bytes).
* ``precision_scope(dtype)``: f32 (and f64) runs trace their dots at full
  float32 precision.  Without it XLA may run an f32 matmul on the GPU's
  tensor cores in TF32, which keeps about three decimal digits.
* ``enable_compile_cache()``: the persistent compile cache lives where
  ``JAX_COMPILATION_CACHE_DIR`` says, else in ``.jax_cache`` inside the
  checkout (a fixed path: the path is part of the cache key).
* ``visible_gpus()``: the card ids a launcher may hand out, one process per
  card, found without starting JAX.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import subprocess

PLATFORMS = ("cpu", "gpu")
DEFAULT_DTYPE = {"cpu": "float32", "gpu": "bfloat16"}
CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class PlatformError(RuntimeError):
    """The requested or detected platform is not one this program runs on."""


def backend() -> str:
    """The JAX default backend, checked against the supported platforms."""
    import jax

    name = jax.default_backend()
    if name not in PLATFORMS:
        raise PlatformError(
            f"JAX backend {name!r} is not supported; this program runs on "
            f"{' or '.join(PLATFORMS)}")
    return name


def select(name: str) -> str:
    """Apply ``--platform`` before the first computation; returns the
    backend in use.  ``auto`` keeps JAX's own choice (the GPU when one is
    visible) but still refuses an unsupported backend."""
    if name not in ("auto",) + PLATFORMS:
        raise PlatformError(f"unknown platform {name!r}")
    if name != "auto":
        import jax

        jax.config.update("jax_platforms", name)
    try:
        got = backend()
    except RuntimeError as e:  # no such backend on this machine
        raise PlatformError(f"--platform {name}: {e}") from None
    if name != "auto" and got != name:
        raise PlatformError(
            f"--platform {name} was asked for but JAX runs on {got!r}")
    return got


def default_dtype() -> str:
    return DEFAULT_DTYPE[backend()]


def precision_scope(dtype):
    """Context in which the solver and evaluator trace their programs:
    float32 matmul precision for f32/f64 storage, JAX's default (native
    bf16 products, f32 accumulation) for bf16."""
    import jax
    import jax.numpy as jnp

    if jnp.dtype(dtype) in (jnp.dtype(jnp.float32), jnp.dtype(jnp.float64)):
        return jax.default_matmul_precision("highest")
    return contextlib.nullcontext()


def compile_cache_dir() -> str:
    return os.environ.get(CACHE_ENV) or os.path.join(REPO_ROOT, ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at ``compile_cache_dir()``;
    call before the first compile."""
    import jax

    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    return path


def visible_gpus() -> list:
    """Ids of the GPUs a child process may be pinned to with
    ``CUDA_VISIBLE_DEVICES``: the list that variable already names, else
    every card ``nvidia-smi`` reports, else none."""
    env = os.environ.get("CUDA_VISIBLE_DEVICES")
    if env is not None:
        return [c.strip() for c in env.split(",") if c.strip()]
    if shutil.which("nvidia-smi") is None:
        return []
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=index", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    return [ln.strip() for ln in out.splitlines() if ln.strip()]
