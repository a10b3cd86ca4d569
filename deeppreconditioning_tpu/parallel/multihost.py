"""Multi-process bootstrap and meshes for the distributed paths.

The reference has no distributed runtime at all (SURVEY.md §2.4); here
``jax.distributed`` starts the processes and XLA's collectives (NCCL on
GPUs) carry the communication.  This module wraps the bootstrap so every
entry point can opt in with one call, and builds the 1-D meshes the
solver and the trainer use (the GPUs of one host are joined all to all,
so device order does not matter).

To run one process per GPU, launch the same program on every process
with an explicit coordinator:
    JAX_COORDINATOR_ADDRESS=<host0>:<port> JAX_NUM_PROCESSES=<N>
    JAX_PROCESS_ID=<i> python your_script.py
One process can also drive every GPU of a host with no bootstrap.
"""

from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh


def initialize_if_needed() -> bool:
    """Initialize jax.distributed when a multi-process env is configured.

    Returns True when running multi-process.  Safe to call always:
    single-process runs skip initialization.

    Must run before anything touches the XLA backend — so the env check
    comes first and no jax.devices()/process_count() call happens on
    the single-process path (those would initialize the backend and
    make a later ``jax.distributed.initialize`` impossible).
    """
    coordinator = os.environ.get("JAX_COORDINATOR_ADDRESS")
    num_processes = os.environ.get("JAX_NUM_PROCESSES")
    if not (coordinator and num_processes):
        return False
    if jax.distributed.is_initialized():
        return True
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=int(num_processes),
        process_id=int(os.environ.get("JAX_PROCESS_ID", "0")),
    )
    return True


def solver_mesh(axis_name: str = "x") -> Mesh:
    """1-D mesh over all devices (global, multi-host aware) for the
    row-partitioned solver, in jax.devices() order."""
    return Mesh(np.array(jax.devices()), (axis_name,))


def train_mesh(dp: int | None = None, axis_names=("dp",)) -> Mesh:
    """Data-parallel mesh for training (batch axis over all devices)."""
    devs = np.array(jax.devices())
    if dp is not None:
        devs = devs[:dp]
    return Mesh(devs, axis_names)
