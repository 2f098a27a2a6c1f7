"""Test configuration: force the CPU platform (with 8 virtual devices so the
multi-device sharding paths are exercised without accelerators) and share the
repo's persistent compile cache (utils/compile_cache.py).

The device-count flag must reach XLA through XLA_FLAGS before the backend
initializes; the platform is pinned through jax.config for the same reason.
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

from quadruped_pympc_tamols.utils.compile_cache import enable_compile_cache  # noqa: E402

jax.config.update("jax_platforms", "cpu")
enable_compile_cache()

assert jax.devices()[0].platform == "cpu"
