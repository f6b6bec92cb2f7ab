"""Test configuration.

Forces the CPU backend with 8 virtual devices (the multi-chip emulation
strategy: ``XLA_FLAGS=--xla_force_host_platform_device_count=8``) so the
full dtype matrix (incl. float64/complex128) and the mesh-sharded paths
run without accelerator hardware.

The platform is also pinned through ``jax.config``, which wins over
anything set at interpreter start; it must happen before any JAX backend
initializes (they initialize lazily at the first computation).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
