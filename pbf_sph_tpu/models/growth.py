"""Shared capacity-growth policy.

One frame's outputs report every static capacity the compiled step depends
on (cell occupancy, triangle count, MC emission rows, query-cell
population).  When any of them
overflows, the frame's physics is suspect (candidates/triangles/ids were
dropped) and the step must be rebuilt under a larger spec and re-run.

This module is the single decision procedure for that growth — consumed by
`JaxSolver.advance` (re-run the same frame under the grown spec) and by
`settle` (the device-resident warmup of `bench.py` and `chip_smoke.py`:
restart from a fresh state under the grown spec).

The policy mirrors the reference's unbounded behavior up to
capacity-with-growth: the reference uses std::vector everywhere
(`src/omp/ompsph.hpp:167-186` queries, `src/ocl/oclsph.cpp:192-211`
triangle buffers), which has no equivalent under static shapes.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Any, Dict

import numpy as np


def growth_changes(spec, out) -> Dict[str, Any]:
    """Return the `dataclasses.replace(spec, **changes)` field changes needed
    after a step produced outputs `out`; empty dict = all capacities held.

    `spec` is a `StepSpec`; `out` is the step's outputs dict (host-readable
    scalars are pulled here — call outside any jit).
    """
    changes: Dict[str, Any] = {}

    # cell occupancy -> cell_capacity.  1.5x headroom: occupancy keeps rising
    # while the fluid compresses; growing to the observed max exactly causes
    # a recompile every few frames.
    occ = int(out["max_occupancy"])
    if occ > spec.cell_capacity:
        changes["cell_capacity"] = -(-int(occ * 1.5) // 16) * 16

    # triangle count -> surface.tri_capacity
    if spec.surface is not None:
        tri = int(out["tri_count"])
        if tri > spec.surface.tri_capacity:
            changes["surface"] = dataclasses.replace(
                spec.surface, tri_capacity=-(-int(tri * 1.5) // 1024) * 1024
            )

        # compacted-emission live-cube rows -> surface.cube_cap (emit_overflow
        # = live cubes beyond the cap; the march volume is the hard ceiling,
        # at which the compaction sort degenerates to the global path's cost
        # but stays correct)
        eovf = int(out.get("mc_emit_overflow", 0))
        if eovf > 0 and spec.surface.cube_cap > 0:
            sur = changes.get("surface", spec.surface)
            vol = int(np.prod([s - 1 for s in sur.sample]))
            new_cap = -(-(sur.cube_cap + eovf) * 5 // 4 // 128) * 128
            changes["surface"] = dataclasses.replace(
                sur, cube_cap=min(new_cap, vol))
        # blocked-emission staging rows -> surface.emit_cap; a block denser
        # than the whole two-stage scheme can amortize falls back to the
        # single global sort (emit_block=0), which is correct at any density
        elif eovf > 0 and spec.surface.emit_block > 0:
            from pbf_sph_tpu.ops.mc import EMIT_CAP_DEFAULT

            sur = changes.get("surface", spec.surface)
            cur = max(128, sur.emit_cap or EMIT_CAP_DEFAULT)
            new_cap = -(-(cur + eovf) * 5 // 4 // 128) * 128
            if new_cap >= 15 * sur.emit_block:
                changes["surface"] = dataclasses.replace(
                    sur, emit_block=0, emit_cap=0)
            else:
                changes["surface"] = dataclasses.replace(sur, emit_cap=new_cap)

    # query-cell population -> scene.query_capacity (reference semantics are
    # unbounded)
    q_ovf = int(out.get("query_overflow", 0))
    if q_ovf > 0:
        sc = spec.scene
        new_q = -(-(sc.query_capacity + q_ovf) // 128) * 128
        changes["scene"] = dataclasses.replace(sc, query_capacity=new_q)

    return changes


def settle(solver, spec, state, dyn, scn, xs, warmup: int, rounds: int = 6):
    """Compile and run `warmup` device-resident frames, growing the spec
    until one whole round holds every capacity; returns (spec, state).

    A capacity overflow means dropped candidates, i.e. corrupted physics, so
    after any growth the round restarts from a FRESH state built from `xs`:
    frames computed with dropped pairs collapse the state and inflate every
    later capacity estimate.  The round is judged on its peak occupancy, not
    just the last frame's."""
    import jax

    from pbf_sph_tpu.core.types import FluidState

    for _ in range(rounds):
        occs = []
        for _ in range(warmup):
            state, out = solver.step_device(spec, state, dyn, scn)
            occs.append(out["max_occupancy"])
        out = dict(out)
        out["max_occupancy"] = max(int(o) for o in occs)
        changes = growth_changes(spec, out)
        if not changes:
            return spec, state
        print(f"# growing: {changes}", file=sys.stderr)
        spec = dataclasses.replace(spec, **changes)
        state = jax.device_put(
            FluidState.from_soa(xs, spec.capacity, solver.dtype))
    # mirrors JaxSolver.advance's convergence error: measuring frames
    # computed with dropped candidates would be benchmarking corrupted physics
    raise RuntimeError(f"capacity growth did not converge: {changes}")
