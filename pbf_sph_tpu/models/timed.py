"""Per-phase timed advance — the reference's Stopwatch table.

The reference brackets every phase with a Stopwatch entry and inserts a
queue.finish() per phase when `config.wait` is set (reference
`src/omp/ompsph.hpp:89-482`, `src/ocl/oclsph.cpp:249-298`).  The fused jitted
step can't be timed per phase, so this module builds the same pipeline as
separately-jitted stages with a device sync between entries.  Numerics are
identical (same ops functions); only the jit boundaries differ.

The stages are built ONCE per spec and take every per-frame value as an
explicit argument: a closed-over device array becomes a constant baked into
the trace, so per-frame closures would make every frame a brand-new
executable that neither the in-process jit cache nor the persistent compile
cache could ever hit, and each table entry would be mostly compile time.

Keep the stage sequence in sync with `jax_solver.build_step`.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from pbf_sph_tpu.core.types import FluidState, ParticleSoA, Result, Scene, SphParams
from pbf_sph_tpu.models.jax_solver import (
    JaxSolver,
    StepSpec,
    _apply_drains,
    _apply_sources,
    _queries,
    dyn_params_of,
    scene_arrays_of,
)
from pbf_sph_tpu.ops import mc as mc_ops
from pbf_sph_tpu.ops import pbf
from pbf_sph_tpu.ops.grid import (
    build_cell_table,
    cell_coords,
    decode_key,
    sort_key,
    stencil_ranges,
)
from pbf_sph_tpu.utils.stopwatch import Stopwatch

# spec -> stage dict; specs are frozen dataclasses (hashable)
_STAGES: Dict[StepSpec, Dict[str, Any]] = {}


def _build_stages(spec: StepSpec) -> Dict[str, Any]:
    dtype = jnp.dtype(spec.dtype)
    h = spec.h
    scale = jnp.asarray(spec.scale, dtype)
    K = spec.cell_capacity
    st: Dict[str, Any] = {}

    @jax.jit
    def sources_drains(state, scn):
        state, _ = _apply_sources(state, scn, spec, dtype)
        return _apply_drains(state, scn, spec)

    st["sources_drains"] = sources_drains

    @jax.jit
    def advect_stage(state, dyn, scn):
        min_extent = dyn["min_bound"].astype(dtype) / scale - jnp.asarray(h, dtype) * 2
        vel, pstar = pbf.advect(
            state.position, state.velocity, state.mass, state.ptype, state.alive,
            scn["wells_centre"], scn["wells_force"], dyn["constant_force"].astype(dtype),
            dyn["dt"].astype(dtype), scale,
        )
        cells = cell_coords(pstar, min_extent, h)
        key = sort_key(cells, state.alive, spec.grid)
        return vel, pstar, key, min_extent

    st["advect"] = advect_stage

    @jax.jit
    def sort_stage(state, vel, pstar, key):
        ops = jax.lax.sort(
            (key, state.pid, state.ptype, state.mass,
             state.position[0], state.position[1], state.position[2],
             vel[0], vel[1], vel[2],
             state.colour[0], state.colour[1], state.colour[2], state.colour[3],
             state.alive, pstar[0], pstar[1], pstar[2]),
            num_keys=1, is_stable=True,
        )
        sorted_state = FluidState(
            pid=ops[1], ptype=ops[2], mass=ops[3],
            position=jnp.stack(ops[4:7]), velocity=jnp.stack(ops[7:10]),
            colour=jnp.stack(ops[10:14]), alive=ops[14],
        )
        return ops[0], sorted_state, jnp.stack(ops[15:18])

    st["sort"] = sort_stage
    st["gridtable"] = jax.jit(lambda k: build_cell_table(k, spec.grid))
    st["queries"] = jax.jit(
        lambda state, tbl, scn, min_extent: _queries(
            scn, spec, state.pid, state.ptype, state.alive, tbl, min_extent, dtype
        )
    )
    st["decode"] = jax.jit(lambda k: decode_key(k, spec.grid))

    @jax.jit
    def diffuse_stage(state, cells, member, cell_table, dyn):
        ranges = stencil_ranges(cells, member, cell_table, spec.grid)
        return pbf.diffuse(
            state.colour, state.ptype, state.alive, ranges, K, dyn["dt"].astype(dtype)
        )

    st["diffuse"] = diffuse_stage

    @jax.jit
    def iter_stage(pstar, state, cells, member, cell_table, dyn):
        ranges = stencil_ranges(cells, member, cell_table, spec.grid)
        lam = pbf.lambda_phase(pstar, state.mass, state.ptype, state.alive, ranges, K, h)
        return pbf.delta_phase(
            pstar, lam, state.ptype, state.alive, ranges, K, h, scale,
            dyn["min_bound"].astype(dtype), dyn["max_bound"].astype(dtype),
        )

    st["iter"] = iter_stage

    st["finalise"] = jax.jit(
        lambda p, v, ps, state, dyn: pbf.finalise(
            p, v, ps, state.ptype, state.alive, dyn["dt"].astype(dtype), scale, dtype
        )
    )

    if spec.surface is not None:

        @jax.jit
        def field_stage(position, colour, state, cell_table, min_extent, dyn):
            return mc_ops.mc_field(
                position, colour, state.ptype, state.alive, cell_table, spec.grid,
                min_extent, spec.grid.extent, spec.surface, K, h, scale,
                dyn["mc_particle_size"].astype(dtype),
                dyn["mc_particle_influence"].astype(dtype),
            )

        st["field"] = field_stage
        st["extract"] = jax.jit(
            lambda lat, min_extent, dyn: mc_ops.mc_extract(
                lat[0], lat[1], lat[2], min_extent, spec.grid.extent,
                spec.surface, h, scale, dyn["mc_isolevel"].astype(dtype),
            )
        )
    return st


def advance_timed(
    solver: JaxSolver, config: SphParams, scene: Scene, xs: ParticleSoA
) -> Tuple[Result, ParticleSoA, Stopwatch]:
    """One frame with a per-phase Stopwatch (reference table entry names)."""
    watch = Stopwatch("advance")
    al = solver.CAP_ALIGN
    spec = solver.make_spec(
        config, scene, capacity=max(al, -(-(len(xs) + 64) // al) * al)
    )
    scn = jax.device_put(scene_arrays_of(scene, spec.scene, solver.dtype))
    dyn = jax.device_put(dyn_params_of(config, solver.dtype))
    state = jax.device_put(FluidState.from_soa(xs, spec.capacity, solver.dtype))

    stages = _STAGES.get(spec)
    if stages is None:
        stages = _STAGES[spec] = _build_stages(spec)
    sync = jax.block_until_ready

    stop = watch.start("CPU source+drain")
    state = sync(stages["sources_drains"](state, scn))
    stop()

    stop = watch.start("CPU advect+copy")
    vel, pstar, key, min_extent = sync(stages["advect"](state, dyn, scn))
    stop()

    stop = watch.start("CPU sortz")
    key, state, pstar = sync(stages["sort"](state, vel, pstar, key))
    vel = state.velocity
    stop()

    stop = watch.start("CPU gridtable")
    cell_table = sync(stages["gridtable"](key))
    stop()

    stop = watch.start(f"CPU query({spec.scene.n_queries})")
    q_ids, q_counts, _q_ovf = sync(stages["queries"](state, cell_table, scn, min_extent))
    stop()

    cells, member = stages["decode"](key)

    stop = watch.start("\t[dev] sph-diffuse ")
    colour = sync(stages["diffuse"](state, cells, member, cell_table, dyn))
    stop()

    stop = watch.start(f"\t[dev] sph-lambda/delta*{spec.iteration}")
    for _ in range(spec.iteration):
        pstar = stages["iter"](pstar, state, cells, member, cell_table, dyn)
    sync(pstar)
    stop()

    stop = watch.start("\t[dev] sph-finalise")
    position, velocity = sync(stages["finalise"](state.position, vel, pstar, state, dyn))
    stop()

    mesh_out = None
    if spec.surface is not None:
        stop = watch.start("\t[dev] mc-field")
        lat = sync(stages["field"](
            position, colour, state, cell_table, min_extent, dyn
        ))
        stop()

        stop = watch.start("\t[dev] mc-extract")
        mesh_out = sync(stages["extract"](lat, min_extent, dyn))
        stop()

    stop = watch.start("\t[dev] write back")
    new_state = FluidState(
        pid=state.pid, ptype=state.ptype, mass=state.mass,
        position=position, velocity=velocity, colour=colour, alive=state.alive,
    )
    out = {
        "query_ids": q_ids,
        "query_counts": q_counts,
        "alive_count": jnp.sum(new_state.alive).astype(jnp.int32),
    }
    if mesh_out is not None:
        out.update(
            mesh_vs=mesh_out[0], mesh_ns=mesh_out[1], mesh_cs=mesh_out[2],
            tri_count=mesh_out[3],
        )
        # timed runs have no growth loop: a nonzero emit_overflow means the
        # packed mesh is INVALID (vertices after the first dropped row shift)
        # — fail loudly rather than time a corrupted frame (ops/mc.py)
        eovf = int(np.asarray(mesh_out[4]))
        if eovf > 0:
            raise RuntimeError(
                f"mc emit_overflow={eovf}: mesh capacity too small for this "
                f"frame — grow cube_cap/emit_cap (advance() does this "
                f"automatically)")
    result = solver._extract_result(out, scn, spec)
    soa = new_state.to_soa()
    stop()
    return result, soa, watch
