"""Core domain model: particles, scenes, parameters, results.

This is the jit-friendly re-expression of the reference's domain model
(reference `src/sph.hpp:25-125`).  The key departure from the reference is the
state layout: instead of an AoS ``std::vector<Particle>`` that grows/shrinks
(reference `src/omp/ompsph.hpp:94-118`), particle state is a fixed-capacity
structure-of-arrays pytree with an ``alive`` mask, so every jitted step has
static shapes.  Sources set mask bits, drains clear them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

# Particle types (reference `src/sph.hpp:15`).
FLUID = 0
OBSTACLE = 1


# ---------------------------------------------------------------------------
# Host-side scene description (reference `src/sph.hpp:56-80`)
# ---------------------------------------------------------------------------


@dataclass
class Well:
    """Attractor: clamped inverse-square pull within radius 75 world units
    (reference `src/omp/ompsph.hpp:141-147`)."""

    tag: int
    centre: Sequence[float]  # (3,) world space
    force: float


@dataclass
class Source:
    """Particle emitter: spawns floor(sqrt(rate)) x ceil(sqrt(rate)) particles
    in an XZ plane at `centre`, spacing h*scale/2 (reference
    `src/omp/ompsph.hpp:93-105`)."""

    tag: int
    centre: Sequence[float]
    velocity: Sequence[float]
    colour: Sequence[float]  # (4,)
    rate: float


@dataclass
class Drain:
    """Particle sink: removes fluid particles within `width` of `centre`
    (spherical, as the reference actually implements it — its comment notes
    the surface-test FIXME, `src/omp/ompsph.hpp:110-115`)."""

    tag: int
    centre: Sequence[float]
    width: float
    depth: float = 0.0


@dataclass
class Query:
    """Point query: ids of fluid particles in the grid cell containing `point`
    (centre cell only, reference `src/omp/ompsph.hpp:167-186`)."""

    id: int
    point: Sequence[float]


@dataclass
class Scene:
    wells: List[Well] = field(default_factory=list)
    sources: List[Source] = field(default_factory=list)
    drains: List[Drain] = field(default_factory=list)
    queries: List[Query] = field(default_factory=list)


# ---------------------------------------------------------------------------
# Parameters (reference `src/sph.hpp:82-103`)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class McParams:
    """Marching-cubes surface parameters (reference `src/sph.hpp:82-95`)."""

    resolution: float = 2.0
    isolevel: float = 100.0
    particle_size: float = 25.0
    particle_influence: float = 0.5


@dataclass
class SphParams:
    """Per-frame simulation parameters (reference `src/sph.hpp:97-103`).

    These are mutable per frame (the reference benchmark oscillates
    min/max bounds every frame via applyMotionSinXCosZ, `src/sph.hpp:147-158`).
    `h`, `scale` and `iteration` are treated as static under jit (shape/loop
    determining); dt / bounds / force are dynamic jit arguments.
    """

    dt: float
    scale: float
    iteration: int
    constant_force: Tuple[float, float, float]
    min_bound: Tuple[float, float, float]
    max_bound: Tuple[float, float, float]
    h: float = 0.1
    # Reference semantics: gate a device sync after every phase
    # (`src/sycl/syclsph.hpp:179-181`).  Here it gates the per-phase-sync
    # timed pipeline under --phase-timings (cli.py); the production path is
    # one fused jitted step, where a per-phase sync cannot exist by design.
    wait: bool = True
    surface: Optional[McParams] = None

    def replace(self, **kw) -> "SphParams":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Particle state
# ---------------------------------------------------------------------------


@dataclass
class ParticleSoA:
    """Host-side (NumPy) structure-of-arrays particle store.

    The host analogue of the reference's ``std::vector<Particle>``
    (reference `src/sph.hpp:36-54`); variable length, no capacity padding.
    """

    pid: np.ndarray  # (n,) int32
    ptype: np.ndarray  # (n,) int32: FLUID | OBSTACLE
    mass: np.ndarray  # (n,) float
    position: np.ndarray  # (n,3) float, world space
    velocity: np.ndarray  # (n,3) float
    colour: np.ndarray  # (n,4) float

    def __len__(self) -> int:
        return int(self.pid.shape[0])

    @staticmethod
    def empty(dtype=np.float32) -> "ParticleSoA":
        return ParticleSoA(
            pid=np.zeros((0,), np.int32),
            ptype=np.zeros((0,), np.int32),
            mass=np.zeros((0,), dtype),
            position=np.zeros((0, 3), dtype),
            velocity=np.zeros((0, 3), dtype),
            colour=np.zeros((0, 4), dtype),
        )

    @staticmethod
    def concat(parts: Sequence["ParticleSoA"]) -> "ParticleSoA":
        return ParticleSoA(
            pid=np.concatenate([p.pid for p in parts]),
            ptype=np.concatenate([p.ptype for p in parts]),
            mass=np.concatenate([p.mass for p in parts]),
            position=np.concatenate([p.position for p in parts]),
            velocity=np.concatenate([p.velocity for p in parts]),
            colour=np.concatenate([p.colour for p in parts]),
        )

    def copy(self) -> "ParticleSoA":
        return ParticleSoA(
            pid=self.pid.copy(),
            ptype=self.ptype.copy(),
            mass=self.mass.copy(),
            position=self.position.copy(),
            velocity=self.velocity.copy(),
            colour=self.colour.copy(),
        )

    def order_by_id(self) -> "ParticleSoA":
        o = np.argsort(self.pid, kind="stable")
        return ParticleSoA(
            self.pid[o], self.ptype[o], self.mass[o],
            self.position[o], self.velocity[o], self.colour[o],
        )


@dataclass
class FluidState:
    """Device-side fixed-capacity particle state pytree.

    Layout note: vector quantities are **component-major** — position and
    velocity are (3, C), colour is (4, C) — so the long particle axis is the
    contiguous one and each component is a dense (C,) row that the phases
    read and write whole.

    Dead slots have ``alive == False`` and are parked at the end of the
    Morton sort order.
    """

    pid: Any  # (C,) int32
    ptype: Any  # (C,) int32
    mass: Any  # (C,) f
    position: Any  # (3,C) f
    velocity: Any  # (3,C) f
    colour: Any  # (4,C) f
    alive: Any  # (C,) bool

    @property
    def capacity(self) -> int:
        return int(self.pid.shape[0])

    @staticmethod
    def from_soa(soa: ParticleSoA, capacity: int, dtype=np.float32) -> "FluidState":
        n = len(soa)
        if n > capacity:
            raise ValueError(f"{n} particles exceed capacity {capacity}")
        pad = capacity - n

        def pad1(a, fill=0):
            return np.concatenate(
                [a, np.full(a.shape[:-1] + (pad,), fill, a.dtype)], axis=-1
            )

        return FluidState(
            pid=pad1(soa.pid.astype(np.int32)),
            ptype=pad1(soa.ptype.astype(np.int32)),
            mass=pad1(soa.mass.astype(dtype)),
            position=pad1(np.ascontiguousarray(soa.position.astype(dtype).T)),
            velocity=pad1(np.ascontiguousarray(soa.velocity.astype(dtype).T)),
            colour=pad1(np.ascontiguousarray(soa.colour.astype(dtype).T)),
            alive=np.concatenate([np.ones(n, bool), np.zeros(pad, bool)]),
        )

    def to_soa(self) -> ParticleSoA:
        """Extract live particles to host, preserving current (sorted) order —
        the reference writes back in z-sorted order too (`src/omp/ompsph.hpp:480`)."""
        alive = np.asarray(self.alive)
        idx = np.nonzero(alive)[0]
        return ParticleSoA(
            pid=np.asarray(self.pid)[idx],
            ptype=np.asarray(self.ptype)[idx],
            mass=np.asarray(self.mass)[idx],
            position=np.asarray(self.position).T[idx],
            velocity=np.asarray(self.velocity).T[idx],
            colour=np.asarray(self.colour).T[idx],
        )


# ---------------------------------------------------------------------------
# Results (reference `src/sph.hpp:105-117`)
# ---------------------------------------------------------------------------


@dataclass
class ColouredMesh:
    """Triangle soup with per-vertex normals and colours
    (reference `src/sph.hpp:105-112`)."""

    vs: np.ndarray  # (3*T, 3)
    ns: np.ndarray  # (3*T, 3)
    cs: np.ndarray  # (3*T, 4)

    @staticmethod
    def empty(dtype=np.float32) -> "ColouredMesh":
        return ColouredMesh(
            np.zeros((0, 3), dtype), np.zeros((0, 3), dtype), np.zeros((0, 4), dtype)
        )

    def __len__(self) -> int:
        return int(self.vs.shape[0])


@dataclass
class QueryResult:
    id: int
    point: np.ndarray
    neighbours: np.ndarray  # (k,) int32 particle ids


@dataclass
class Result:
    mesh: ColouredMesh = field(default_factory=ColouredMesh.empty)
    queries: List[QueryResult] = field(default_factory=list)


# Register FluidState as a JAX pytree lazily so NumPy-only use never imports jax.
def _register_pytree() -> None:
    import jax

    try:
        jax.tree_util.register_dataclass(
            FluidState,
            data_fields=["pid", "ptype", "mass", "position", "velocity", "colour", "alive"],
            meta_fields=[],
        )
    except ValueError:
        pass  # already registered


try:  # pragma: no cover - registration is exercised implicitly everywhere
    _register_pytree()
except ImportError:  # pragma: no cover
    pass
