"""Test configuration: force JAX onto a virtual 8-device CPU mesh.

This is the standard JAX trick for exercising multi-device sharding logic
without several accelerators.  The platform is pinned through jax.config
(as well as any JAX_PLATFORMS the caller set) before any backend
initializes; XLA_FLAGS is read at backend-init time, so setting it here
still works.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    flags = (flags + " --xla_force_host_platform_device_count=8").strip()
# XLA:CPU in-process collectives abort when device threads arrive at a
# rendezvous > 40 s apart — routine when one core emulates 8 devices
# running a heavy per-tile stage.  Raise each watchdog unless the caller
# already set it.
for _f in ("--xla_cpu_collective_call_warn_stuck_timeout_seconds=600",
           "--xla_cpu_collective_call_terminate_timeout_seconds=1200"):
    if _f.split("=")[0] not in flags:
        flags += " " + _f
os.environ["XLA_FLAGS"] = flags

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

# Persistent compilation cache: the slow tier is dominated by CPU compiles
# of the surface/sharded pipelines; the cache is keyed by HLO hash so it is
# safe across code changes and cuts re-runs of unchanged tests from minutes
# to seconds.
from pbf_sph_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache("tests")

assert jax.default_backend() == "cpu", "tests must run on the CPU backend"
assert len(jax.devices()) == 8
