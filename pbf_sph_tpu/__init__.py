"""pbf-sph-tpu: a Position-Based-Fluids SPH engine in JAX.

A ground-up re-design of the capabilities of UoB-HPC/pbf-sph (a C++/OpenMP/
OpenCL/SYCL PBF mini-app): the whole simulation step is one jitted XLA
program with static shapes over cell-sorted particles, and multi-device
scaling is spatial domain decomposition over a `jax.sharding.Mesh` with halo
exchange.

Backends (mirroring the reference's solver multiplexing, reference
`src/benchmark.cpp:105-172`):
  * ``jax``    — the XLA engine (runs on the GPU, or the CPU for tests)
  * ``cpp``    — C++/OpenMP oracle (the fidelity anchor, equivalent of the
                 reference's `src/omp/ompsph.hpp` backend)
  * ``numpy``  — pure NumPy oracle for CI without a compiler
"""

__version__ = "0.1.0"

from pbf_sph_tpu.core.constants import SphConstants
from pbf_sph_tpu.core.types import FluidState, McParams, Scene, SphParams
from pbf_sph_tpu.core import scene as scene_builders
from pbf_sph_tpu.models import make_solver

__all__ = [
    "SphConstants",
    "FluidState",
    "McParams",
    "Scene",
    "SphParams",
    "scene_builders",
    "make_solver",
]
