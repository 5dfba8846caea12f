"""Test configuration: run on a virtual 8-device CPU mesh with x64 enabled.

Must set the env vars before jax is imported anywhere.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from one_class_ffm_tpu.solver.oracle import (  # noqa: E402,F401
    dense_to_padded,
    make_problem,
    oracle_params_to_jax,
    random_sparse_dense,
    to_device_problem,
)


@pytest.fixture
def rng():
    return np.random.default_rng(0)
