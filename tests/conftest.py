"""Test configuration: CPU, 8 virtual devices, float64.

The tests run on the CPU (``JAX_PLATFORMS=cpu``; the platform is also
pinned here so a host with a GPU runs the same suite).  Multi-device code
(parallel/) is tested the standard JAX way — a virtual CPU mesh via
``--xla_force_host_platform_device_count`` — so the full sharding path
runs without a GPU cluster.

The persistent compilation cache is off here: CPU test programs gain
nothing from it, and concurrent test workers would share one directory.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
jax.config.update("jax_enable_compilation_cache", False)
