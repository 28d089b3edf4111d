"""Solver backends.

Mirrors the reference's one-abstract-interface / N-implementations design
(`Solver::advance`, reference `src/sph.hpp:119-125`; backend dispatch,
reference `src/benchmark.cpp:105-172`).
"""

from __future__ import annotations

from typing import Any

BACKENDS = ("jax", "cpp", "numpy")


def make_solver(impl: str, h: float = 0.1, **kwargs: Any):
    """Construct a solver backend by name (mirrors the reference's
    `--impl {omp,ocl,sycl,sycl2020}` map, `src/args.hpp:24-30`)."""
    if impl == "numpy":
        from pbf_sph_tpu.models.numpy_solver import NumpySolver

        return NumpySolver(h=h, **kwargs)
    if impl == "cpp":
        from pbf_sph_tpu.models.cpp_solver import CppSolver

        return CppSolver(h=h, **kwargs)
    if impl == "jax":
        from pbf_sph_tpu.models.jax_solver import JaxSolver

        return JaxSolver(h=h, **kwargs)
    raise ValueError(f"unknown impl {impl!r}; available: {BACKENDS}")
