"""2D tile domain decomposition: shard_map + two-phase halo exchange.

The 1D x-slab engine (`parallel/sharded.py`) runs out of useful slabs on the
1M dam break: the settled dam occupies ~27 of 88 x-columns, so at
min-width-3 slabs only ~9 devices carry fluid.  This module decomposes over a
2D `Mesh((nx, ny), ("x","y"))` of (x, y) TILES instead.

Design (tensor-product tiles, fixed equal-count bounds):

  * tile bounds are STATIC: x-cuts from the initial particle x-CDF, y-cuts
    from the global y-CDF (cell-granular, >= 3 columns/rows per tile) —
    a tensor-product partition so a one-axis hop never changes the other
    axis's owner (the per-axis one-hop migration invariant of the 1D
    engine holds independently per axis);
  * migration is TWO-PHASE: pack/ppermute along "x", merge, then along "y"
    — a diagonal move completes within one frame;
  * ghost exchange is TWO-PHASE with the classic halo trick: the x-pass
    exchanges owned boundary COLUMNS; the y-pass then scans owned rows AND
    the just-installed x-ghosts, so corner neighbourhoods ride the y-pass
    without explicit diagonal sends;
  * the per-iteration lambda/pStar halo refresh applies the same two-phase
    order (x first, so y-ghost values sourced from x-ghost rows are fresh);
  * the constraint pipeline is the SHARED single-chip `neighbour_phases`,
    exactly as in the 1D engine.

Scope: the FULL pipeline — sources/drains/wells/queries, the shared
constraint pipeline, tile-local marching cubes (the 2D node partition: each
tile evaluates nodes [bx*res, bx1*res] x [by*res, by1*res] over all z and
owns cubes with global x < bx1*res AND y < by1*res; boundary nodes gather
from the ghost columns/rows the two-phase halo already installs, corner
nodes from the corner ghosts that ride the y-pass), and dynamic tensor-
product rebalancing (per-axis equal-count cuts from the global marginal
CDFs, movement clamped to one column/frame per axis — the same one-hop
invariant as the 1D engine, held independently per axis).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from pbf_sph_tpu.core.types import FLUID, FluidState, Scene
from pbf_sph_tpu.models.jax_solver import (
    SceneSpec,
    StepSpec,
    _apply_drains,
    _apply_sources,
    neighbour_phases,
    scene_spec_of,
)
from pbf_sph_tpu.ops import pbf
from pbf_sph_tpu.ops.grid import GridSpec, build_cell_table
from pbf_sph_tpu.parallel.sharded import (  # noqa: F401  (gather_mesh re-exported)
    _compact_first,
    _equal_count_target,
    _perm,
    gather_mesh,
)

AXX = "x"
AXY = "y"


def _axis_cap(g: int, n: int, min_w: int, cap: int = 0) -> int:
    """Max tile width cap along one axis (rebalance mode): 0 = 3x uniform,
    clamped feasible — the 1D engine's max_slab_w policy per axis."""
    cap = cap or -(-3 * g // n)
    cap = max(cap, min_w, -(-g // n))
    return min(cap, g - (n - 1) * min_w)


def _equal_count_cuts(vals, lo, hi, n, min_w=3, max_w=None):
    """Equal-count cell-granular cuts of [lo, hi) into n ranges with widths
    in [min_w, max_w]."""
    hist = np.bincount(np.clip(vals, lo, hi - 1) - lo, minlength=hi - lo)
    cdf = np.cumsum(hist)
    total = int(cdf[-1])
    g = hi - lo
    xw = max_w if max_w is not None else g
    b = [lo]
    for d in range(1, n):
        v = lo + int(np.searchsorted(cdf, total * d / n, side="left")) + 1
        v = min(max(v, b[-1] + min_w, hi - xw * (n - d)),
                hi - min_w * (n - d), b[-1] + xw)
        b.append(v)
    b.append(hi)
    return tuple(int(x) for x in b)


@dataclass(frozen=True)
class Shard2DSpec:
    nx: int
    ny: int
    cap_local: int       # owned-particle capacity per tile
    ghost_x: int         # x-ghost slots per side (boundary columns)
    ghost_y: int         # y-ghost slots per side (boundary rows incl. x-ghosts)
    migrate_cap: int     # migration slots per direction per phase
    xb: Tuple[int, ...]  # static x-cuts, (nx+1,), xb[0]=0, xb[-1]=gx
    yb: Tuple[int, ...]  # static y-cuts, (ny+1,)
    grid_global: GridSpec
    h: float
    scale: float
    iteration: int
    cell_capacity: int
    dtype: str = "float32"
    scene: SceneSpec = SceneSpec()
    min_bound: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    # LOCAL marching-cubes spec (wx_max*res+1 x wy_max*res+1 node columns);
    # None = no surface.  Requires integer resolution: the per-tile node
    # offset bx*res must be a whole node index at every (data-dependent)
    # equal-count cut.
    surface: object = None
    # Dynamic tensor-product rebalancing: xb/yb become per-frame traced
    # arrays re-partitioned from the global marginal particle CDFs (one
    # (gx,)+(gy,) psum pair per frame), movement clamped to rebalance_step
    # columns/frame per axis, widths kept in [min_w, max-width cap] — the
    # per-axis one-hop migration invariant holds exactly as in the 1D
    # engine (sharded.py ShardSpec.rebalance).
    rebalance: bool = False
    rebalance_step: int = 1
    min_w: int = 3
    # max tile width cap per axis (columns; 0 = 3x uniform, clamped
    # feasible) — bounds the static local grid/lattice under rebalancing
    max_wx_cap: int = 0
    max_wy_cap: int = 0

    @property
    def wx_max(self) -> int:
        if self.rebalance:
            return _axis_cap(self.grid_global.dims[0], self.nx, self.min_w,
                             self.max_wx_cap)
        return max(b - a for a, b in zip(self.xb, self.xb[1:]))

    @property
    def wy_max(self) -> int:
        if self.rebalance:
            return _axis_cap(self.grid_global.dims[1], self.ny, self.min_w,
                             self.max_wy_cap)
        return max(b - a for a, b in zip(self.yb, self.yb[1:]))

    @property
    def grid_local(self) -> GridSpec:
        gz = self.grid_global.dims[2]
        return GridSpec(
            extent=(self.wx_max + 1, self.wy_max + 1, gz - 1),
            maxz=self.grid_global.maxz,
            quirks=False,
        )

    @property
    def cap_total(self) -> int:
        return self.cap_local + 2 * self.ghost_x + 2 * self.ghost_y

    @staticmethod
    def create(config, nx: int, ny: int, soa, h: float,
               cell_capacity: int = 48, dtype: str = "float32",
               cap_local: int = 0, scene: Scene = None,
               min_w: int = 3,
               rebalance: bool = False) -> "Shard2DSpec":
        grid = GridSpec.from_bounds(config.min_bound, config.max_bound,
                                    config.scale, h)
        gx, gy, gz = grid.dims
        if gx < nx * min_w or gy < ny * min_w:
            raise ValueError(
                f"grid {gx}x{gy} columns/rows cannot hold {nx}x{ny} tiles of "
                f">= {min_w} cells")
        if config.surface is not None:
            # equal-count cuts land on arbitrary columns, so every per-tile
            # node offset b*res must be a whole node index (the 1D engine
            # has the same constraint in rebalance mode)
            if not float(config.surface.resolution).is_integer():
                raise ValueError(
                    "2D tile surface extraction requires an integer MC "
                    "resolution (the tile node partition shifts by whole "
                    "columns)")
        sspec = scene_spec_of(scene or Scene(), config)
        scale = np.float32(config.scale)
        hf = np.float32(h)
        me = np.asarray(config.min_bound, np.float32) / scale - hf * 2
        gcx = np.trunc((soa.position[:, 0].astype(np.float32) / scale - me[0]) / hf).astype(np.int64)
        gcy = np.trunc((soa.position[:, 1].astype(np.float32) / scale - me[1]) / hf).astype(np.int64)
        # rebalance mode bounds the static local grid/lattice by the width
        # caps, so the initial cuts must respect them too
        wx_cap = _axis_cap(gx, nx, min_w) if rebalance else None
        wy_cap = _axis_cap(gy, ny, min_w) if rebalance else None
        xb = _equal_count_cuts(gcx, 0, gx, nx, min_w, wx_cap)
        yb = _equal_count_cuts(gcy, 0, gy, ny, min_w, wy_cap)
        count = len(soa)
        if cap_local <= 0 and rebalance:
            # per-axis equal-count cuts bound the marginal, not the joint,
            # tile count; 3x headroom over uniform absorbs the residual
            # (zero-drop validated by the 2D sloshing tests)
            per = (count + sspec.total_spawn) / (nx * ny)
            cap_local = max(256, -(-int(per * 3) // 128) * 128)
        if cap_local <= 0:
            # static tiles under the sloshing motion can concentrate most of
            # one x-band into one tile; default to the whole-set bound like
            # the fixed 1D mode (callers with balanced workloads pass less)
            cap_local = max(256, -(-int(count + sspec.total_spawn) // 128) * 128)
        # ghost capacities: one boundary column (x) / one boundary row incl.
        # x-ghost columns (y) at 8 particles/cell, like the 1D default
        ghost_x = max(128, -(-(gy * gz * 8) // 128) * 128)
        wx_loc = (wx_cap if rebalance
                  else max(b - a for a, b in zip(xb, xb[1:]))) + 2
        ghost_y = max(128, -(-(wx_loc * gz * 8) // 128) * 128)
        ghost_x = min(ghost_x, cap_local)
        ghost_y = min(ghost_y, cap_local)
        # under rebalancing a boundary move hands a whole column/row (plus
        # drift) to a neighbour in one frame — size generously, like 1D
        migrate_cap = cap_local if rebalance else min(
            cap_local, max(128, max(ghost_x, ghost_y)))
        spec = Shard2DSpec(
            nx=nx, ny=ny, cap_local=cap_local, ghost_x=ghost_x,
            ghost_y=ghost_y, migrate_cap=migrate_cap, xb=xb, yb=yb,
            grid_global=grid, h=h, scale=float(config.scale),
            iteration=int(config.iteration), cell_capacity=cell_capacity,
            dtype=dtype, scene=sspec,
            min_bound=tuple(float(v) for v in np.asarray(config.min_bound, np.float32)),
            rebalance=rebalance, min_w=min_w,
        )
        if config.surface is not None:
            from pbf_sph_tpu.ops.mc import McSpec, default_cube_cap

            res = float(config.surface.resolution)
            gspec = McSpec.from_extent(grid.extent, res)
            # static local lattice sized for the WIDEST possible tile along
            # each axis (wx_max/wy_max are cut-derived in fixed mode, the
            # rebalance width caps otherwise); padding nodes feed only
            # ownership-masked cubes
            local_sample = (
                int(spec.wx_max * res) + 1,
                int(spec.wy_max * res) + 1,
                gspec.sample[2],
            )
            local_vol = int(np.prod([s - 1 for s in local_sample]))
            surface = dataclasses.replace(
                gspec,
                sample=local_sample,
                tri_capacity=max(1024, -(-gspec.tri_capacity // (nx * ny)) * 2),
                cube_cap=default_cube_cap(local_vol),
            )
            spec = dataclasses.replace(spec, surface=surface)
        return spec


def _owner_of(cuts, gc, n):
    """Owning index along one axis under static cuts (device-side)."""
    b = jnp.asarray(cuts, jnp.int32)
    o = jnp.searchsorted(b, gc, side="right").astype(jnp.int32) - 1
    return jnp.clip(o, 0, n - 1)


def build_sharded2d_step(spec: Shard2DSpec, mesh: Mesh):
    """step(state, dyn, scn=None) -> (state, stats); state arrays sharded
    over BOTH mesh axes on the capacity dim (x-major tile order)."""
    dtype = jnp.dtype(spec.dtype)
    NX, NY = spec.nx, spec.ny
    CL = spec.cap_local
    HX = spec.ghost_x
    HY = spec.ghost_y
    M = spec.migrate_cap
    CT = spec.cap_total
    K = spec.cell_capacity
    lgrid = spec.grid_local

    local_spec = StepSpec(
        capacity=CT, cell_capacity=K, grid=lgrid, h=spec.h, scale=spec.scale,
        iteration=spec.iteration, dtype=spec.dtype, scene=spec.scene,
        surface=None,
    )

    def local_step(state: FluidState, dyn: Dict[str, Any], scn: Dict[str, Any],
                   xb, yb):
        mx = jax.lax.axis_index(AXX)
        my = jax.lax.axis_index(AXY)
        bx = xb[mx]
        by = yb[my]
        wx = xb[mx + 1] - bx
        wy = yb[my + 1] - by
        h = spec.h
        scale = jnp.asarray(spec.scale, dtype)
        dt = dyn["dt"].astype(dtype)
        min_bound = dyn["min_bound"].astype(dtype)
        max_bound = dyn["max_bound"].astype(dtype)
        padding = jnp.asarray(h, dtype) * 2
        min_extent = min_bound / scale - padding
        needed = jnp.trunc(
            ((max_bound / scale + padding) - min_extent) / jnp.asarray(h, dtype)
            - jnp.asarray(1e-3, dtype)
        ).astype(jnp.int32)
        extent_ok = jnp.all(
            needed <= jnp.asarray(spec.grid_global.extent, jnp.int32)
        )

        # ghost slots (tail 2HX+2HY rows) always start dead
        alive = state.alive.at[CL:].set(False)
        state = dataclasses.replace(state, alive=alive)

        def owners_of(pos_world):
            gc = []
            for a, cuts, n in ((0, xb, NX), (1, yb, NY)):
                c = jnp.trunc(
                    jnp.clip((pos_world[a] / scale - min_extent[a])
                             / jnp.asarray(h, dtype), -2e9, 2e9)
                ).astype(jnp.int32)
                gc.append(_owner_of(cuts, c, n))
            return gc[0], gc[1]

        # 0a. sources: only the tile owning the spawn cell spawns
        state, src_dropped = _apply_sources(
            state, scn, local_spec, dtype,
            accept=lambda sp: (owners_of(sp)[0] == mx) & (owners_of(sp)[1] == my),
            slot_limit=CL,
        )
        # 0b. drains (purely local)
        state = _apply_drains(state, scn, local_spec)

        # 1. advect
        vel, pstar = pbf.advect(
            state.position, state.velocity, state.mass, state.ptype, state.alive,
            scn["wells_centre"], scn["wells_force"],
            dyn["constant_force"].astype(dtype), dt, scale,
        )

        fields = dict(
            pid=state.pid, ptype=state.ptype, mass=state.mass,
            px=state.position[0], py=state.position[1], pz=state.position[2],
            vx=vel[0], vy=vel[1], vz=vel[2],
            cr=state.colour[0], cg=state.colour[1], cb=state.colour[2],
            ca=state.colour[3],
        )
        alive = state.alive
        migrate_deferred = jnp.asarray(0, jnp.int32)
        migrate_dropped = jnp.asarray(0, jnp.int32)

        def cell_of(arr_world, axis, cuts, n):
            c = jnp.trunc(
                jnp.clip((arr_world / scale - min_extent[axis])
                         / jnp.asarray(h, dtype), -2e9, 2e9)
            ).astype(jnp.int32)
            return _owner_of(cuts, c, n)

        def migrate_phase(axis_name, axis, cuts, n, me_ax, alive,
                          migrate_deferred, migrate_dropped):
            """One migration phase along one mesh axis (pack lo/hi, permute,
            merge into dead owned slots)."""
            nonlocal fields
            # predicted position from the CURRENT fields (immigrants from a
            # previous phase included)
            fluid = (fields["ptype"] == FLUID) & alive
            pw = jnp.where(
                fluid,
                fields["v" + "xyz"[axis]] * dt * scale + fields["p" + "xyz"[axis]],
                fields["p" + "xyz"[axis]],
            )
            owner = cell_of(pw, axis, cuts, n)  # pw is world-space
            owner = jnp.clip(owner, me_ax - 1, me_ax + 1)  # one-hop invariant
            go_lo = alive & (owner < me_ax)
            go_hi = alive & (owner > me_ax)

            def pack(flag):
                idx, valid = _compact_first(flag, M)
                buf = {k: jnp.where(valid, v[idx], 0) for k, v in fields.items()}
                buf["valid"] = valid
                sent = jnp.zeros((CT,), bool).at[idx].set(valid)
                return buf, sent

            send_lo, sent_lo = pack(go_lo)
            send_hi, sent_hi = pack(go_hi)
            unsent = (go_lo & ~sent_lo) | (go_hi & ~sent_hi)
            migrate_deferred = migrate_deferred + jnp.sum(unsent).astype(jnp.int32)
            alive = alive & ((owner == me_ax) | unsent)

            recv_from_hi = jax.tree.map(
                lambda x: jax.lax.ppermute(x, axis_name, _perm(n, -1)), send_lo)
            recv_from_lo = jax.tree.map(
                lambda x: jax.lax.ppermute(x, axis_name, _perm(n, +1)), send_hi)

            def merge(alive, recv, dropped):
                nonlocal fields
                slots_idx, _ = _compact_first(~alive[:CL], M)
                can = (~alive[slots_idx]) & recv["valid"]
                upd = {}
                for k in fields:
                    upd[k] = fields[k].at[slots_idx].set(
                        jnp.where(can, recv[k].astype(fields[k].dtype),
                                  fields[k][slots_idx]))
                fields = upd
                alive = alive.at[slots_idx].set(alive[slots_idx] | can)
                return alive, dropped + jnp.sum(recv["valid"]) - jnp.sum(can)

            alive, migrate_dropped = merge(alive, recv_from_hi, migrate_dropped)
            alive, migrate_dropped = merge(alive, recv_from_lo, migrate_dropped)
            return alive, migrate_deferred, migrate_dropped

        alive, migrate_deferred, migrate_dropped = migrate_phase(
            AXX, 0, xb, NX, mx, alive, migrate_deferred, migrate_dropped)
        alive, migrate_deferred, migrate_dropped = migrate_phase(
            AXY, 1, yb, NY, my, alive, migrate_deferred, migrate_dropped)

        # rebuild vectors; immigrants recompute pstar from v/pos
        position = jnp.stack([fields["px"], fields["py"], fields["pz"]])
        vel = jnp.stack([fields["vx"], fields["vy"], fields["vz"]])
        colour = jnp.stack([fields["cr"], fields["cg"], fields["cb"], fields["ca"]])
        ptype = fields["ptype"]
        pid = fields["pid"]
        mass = fields["mass"]
        fluid = (ptype == FLUID) & alive
        pstar = jnp.stack([
            jnp.where(fluid, vel[a] * dt + position[a] / scale, position[a] / scale)
            for a in range(3)
        ])

        # 3. two-phase ghost exchange (x columns, then y rows incl. x-ghosts)
        def gcell(a):
            return jnp.trunc(
                jnp.clip((pstar[a] - min_extent[a]) / jnp.asarray(h, dtype),
                         -2e9, 2e9)
            ).astype(jnp.int32)

        def ghost_pack(idx, valid):
            return dict(
                px=jnp.where(valid, pstar[0][idx], 1e9),
                py=jnp.where(valid, pstar[1][idx], 1e9),
                pz=jnp.where(valid, pstar[2][idx], 1e9),
                mass=jnp.where(valid, mass[idx], 0),
                ptype=jnp.where(valid, ptype[idx], 0),
                cr=jnp.where(valid, colour[0][idx], 0),
                cg=jnp.where(valid, colour[1][idx], 0),
                cb=jnp.where(valid, colour[2][idx], 0),
                ca=jnp.where(valid, colour[3][idx], 0),
                posx=jnp.where(valid, position[0][idx], 1e9),
                posy=jnp.where(valid, position[1][idx], 1e9),
                posz=jnp.where(valid, position[2][idx], 1e9),
                valid=valid,
            )

        def install(ghost, lo, H):
            nonlocal pstar, mass, ptype, colour, alive, position
            sl = slice(lo, lo + H)
            pstar = (pstar.at[0, sl].set(ghost["px"]).at[1, sl].set(ghost["py"])
                     .at[2, sl].set(ghost["pz"]))
            position = (position.at[0, sl].set(ghost["posx"])
                        .at[1, sl].set(ghost["posy"]).at[2, sl].set(ghost["posz"]))
            mass = mass.at[sl].set(ghost["mass"].astype(dtype))
            ptype = ptype.at[sl].set(ghost["ptype"])
            colour = (colour.at[0, sl].set(ghost["cr"]).at[1, sl].set(ghost["cg"])
                      .at[2, sl].set(ghost["cb"]).at[3, sl].set(ghost["ca"]))
            alive = alive.at[sl].set(ghost["valid"])

        ghost_dropped = jnp.asarray(0, jnp.int32)
        ghost_peak = jnp.asarray(0, jnp.int32)
        packs = {}

        def ghost_phase(axis_name, lc, w, n, lo_slot, H):
            nonlocal ghost_dropped, ghost_peak
            b_lo = alive & (lc == 0)
            b_hi = alive & (lc == w - 1)
            idx_lo, val_lo = _compact_first(b_lo, H)
            idx_hi, val_hi = _compact_first(b_hi, H)
            to_lo = ghost_pack(idx_lo, val_lo)
            to_hi = ghost_pack(idx_hi, val_hi)
            from_lo = jax.tree.map(
                lambda x: jax.lax.ppermute(x, axis_name, _perm(n, +1)), to_hi)
            from_hi = jax.tree.map(
                lambda x: jax.lax.ppermute(x, axis_name, _perm(n, -1)), to_lo)
            install(from_lo, lo_slot, H)
            install(from_hi, lo_slot + H, H)
            ghost_dropped = ghost_dropped + (
                jnp.maximum(jnp.sum(b_lo) - H, 0) + jnp.maximum(jnp.sum(b_hi) - H, 0)
            ).astype(jnp.int32)
            ghost_peak = jnp.maximum(
                ghost_peak, jnp.maximum(jnp.sum(b_lo), jnp.sum(b_hi)).astype(jnp.int32))
            packs[axis_name] = (idx_lo, idx_hi, from_lo["valid"], from_hi["valid"])

        lcx = gcell(0) - bx
        ghost_phase(AXX, lcx, wx, NX, CL, HX)
        # the y-pass scans owned rows AND the just-installed x-ghosts (alive
        # now includes them), so corner regions ride along
        lcy = gcell(1) - by
        ghost_phase(AXY, lcy, wy, NY, CL + 2 * HX, HY)

        # 4. local sort over the local tile grid
        from pbf_sph_tpu.ops.grid import cell_coords, sort_key

        cells_g = cell_coords(pstar, min_extent, h)
        cells_l = (cells_g[0] - bx + 1, cells_g[1] - by + 1, cells_g[2])
        key = sort_key(cells_l, alive, lgrid)
        order = jnp.argsort(key, stable=True)
        inv = jnp.zeros_like(order).at[order].set(jnp.arange(CT, dtype=order.dtype))
        key = key[order]
        pid, ptype, mass, alive = pid[order], ptype[order], mass[order], alive[order]
        position = position[:, order]
        vel = vel[:, order]
        colour = colour[:, order]
        pstar = pstar[:, order]
        cells_l = tuple(c[order] for c in cells_l)
        member = key < lgrid.ncells
        cell_table = build_cell_table(key, lgrid)

        # sorted positions for the per-iteration refresh
        gx_l = inv[CL: CL + HX]
        gx_r = inv[CL + HX: CL + 2 * HX]
        gy_l = inv[CL + 2 * HX: CL + 2 * HX + HY]
        gy_r = inv[CL + 2 * HX + HY: CL + 2 * HX + 2 * HY]
        bx_lo, bx_hi, vx_lo, vx_hi = packs[AXX]
        by_lo, by_hi, vy_lo, vy_hi = packs[AXY]
        px_lo = inv[bx_lo]
        px_hi = inv[bx_hi]
        py_lo = inv[by_lo]
        py_hi = inv[by_hi]

        # 4b. queries: the owning tile scans its centre cell; psum over both
        # mesh axes merges (id+1 protocol as in the 1D engine)
        q_ids, q_counts, q_overflow = _queries_2d(
            spec, scn, mx, my, bx, by, xb, yb, pid, ptype, alive, cell_table,
            min_extent, dtype)

        # 5-6. diffuse + constraint solve with two-phase halo refresh
        def refresh(arr1d):
            # x-phase first: y-ghost rows sourced from x-ghost slots must
            # read refreshed values
            to_l = arr1d[px_lo]
            to_r = arr1d[px_hi]
            fr_l = jax.lax.ppermute(to_r, AXX, _perm(NX, +1))
            fr_r = jax.lax.ppermute(to_l, AXX, _perm(NX, -1))
            arr1d = arr1d.at[gx_l].set(jnp.where(vx_lo, fr_l, arr1d[gx_l]))
            arr1d = arr1d.at[gx_r].set(jnp.where(vx_hi, fr_r, arr1d[gx_r]))
            to_d = arr1d[py_lo]
            to_u = arr1d[py_hi]
            fr_d = jax.lax.ppermute(to_u, AXY, _perm(NY, +1))
            fr_u = jax.lax.ppermute(to_d, AXY, _perm(NY, -1))
            arr1d = arr1d.at[gy_l].set(jnp.where(vy_lo, fr_d, arr1d[gy_l]))
            arr1d = arr1d.at[gy_r].set(jnp.where(vy_hi, fr_u, arr1d[gy_r]))
            return arr1d

        def refresh_pstar(ps):
            return jnp.stack([refresh(ps[a]) for a in range(3)])

        colour, pstar = neighbour_phases(
            lgrid, K, h, spec.iteration,
            cell_table, cells_l, member,
            colour, pstar, mass, ptype, alive,
            dt, scale, min_bound, max_bound,
            refresh_lam=refresh, refresh_pstar=refresh_pstar,
        )

        # 7. finalise
        new_pos, new_vel = pbf.finalise(position, vel, pstar, ptype, alive,
                                        dt, scale, dtype)

        # 7b. tile-local marching cubes (ghosts still alive: boundary nodes
        # gather from the ghost columns/rows, corner nodes from the corner
        # ghosts the y-pass installed; cube ownership is the tensor product
        # x < xb[mx+1]*res AND y < yb[my+1]*res — cubes partition exactly
        # across tiles, no duplicate triangles)
        mesh_out = None
        if spec.surface is not None:
            from pbf_sph_tpu.ops import mc as mc_ops

            res_i = int(spec.surface.resolution)
            node_off = (bx * res_i, by * res_i, 0)
            cell_off = (-(bx - 1), -(by - 1), 0)
            lat_v, lat_n, lat_c = mc_ops.mc_field(
                new_pos, colour, ptype, alive, cell_table, lgrid,
                min_extent, spec.grid_global.extent, spec.surface, K, spec.h,
                scale, dyn["mc_particle_size"].astype(dtype),
                dyn["mc_particle_influence"].astype(dtype),
                node_offset=node_off, cell_offset=cell_off,
                quirk_grid=spec.grid_global,
            )
            vs, ns, cs, total, emit_ovf = mc_ops.mc_extract(
                lat_v, lat_n, lat_c, min_extent, spec.grid_global.extent,
                spec.surface, spec.h, scale, dyn["mc_isolevel"].astype(dtype),
                node_offset=node_off, cube_x_hi=xb[mx + 1] * res_i,
                cube_y_hi=yb[my + 1] * res_i)
            mesh_out = (vs, ns, cs, total, emit_ovf)

        # drop ghosts; compact alive to the front (the sort strands owned
        # rows in the ghost tail otherwise — same hazard as the 1D engine)
        ghost_mask = jnp.zeros((CT,), bool).at[CL:].set(True)[order]
        alive = alive & ~ghost_mask
        order2 = jnp.argsort(~alive, stable=True)
        pid, ptype, mass, alive = (
            pid[order2], ptype[order2], mass[order2], alive[order2])
        new_pos = new_pos[:, order2]
        new_vel = new_vel[:, order2]
        colour = colour[:, order2]

        # 8. tensor-product rebalancing: re-partition each axis's cuts from
        # the global MARGINAL particle CDF (one (gx,)+(gy,) psum pair per
        # frame).  Movement is clamped to rebalance_step columns and widths
        # to [min_w, w*_max], so ownership changes stay within the per-axis
        # one-hop migration budget — the same policy as the 1D engine
        # (sharded.py step 8), applied independently per axis.
        if spec.rebalance:
            def repartition(axis, cuts_now, n, xw):
                g = spec.grid_global.dims[axis]
                gc = jnp.trunc(
                    jnp.clip((new_pos[axis] / scale - min_extent[axis])
                             / jnp.asarray(h, dtype), -2e9, 2e9)
                ).astype(jnp.int32)
                histl = jnp.zeros((g,), jnp.int32).at[
                    jnp.clip(gc, 0, g - 1)
                ].add(alive.astype(jnp.int32))
                # int32-safe equal-count targets (see sharded._equal_count_target)
                cdf = jnp.cumsum(jax.lax.psum(histl, (AXX, AXY)))
                total = cdf[-1]
                S = spec.rebalance_step
                MW = spec.min_w
                bs = [jnp.asarray(0, jnp.int32)]
                for d in range(1, n):
                    target = _equal_count_target(total, d, n)
                    raw = jnp.searchsorted(
                        cdf, target, side="left").astype(jnp.int32) + 1
                    v = jnp.clip(raw, cuts_now[d] - S, cuts_now[d] + S)
                    v = jnp.clip(
                        v, jnp.maximum(bs[-1] + MW, g - xw * (n - d)),
                        jnp.minimum(g - MW * (n - d), bs[-1] + xw))
                    bs.append(v)
                bs.append(jnp.asarray(g, jnp.int32))
                return jnp.stack(bs)

            new_xb = repartition(0, xb, NX, spec.wx_max)
            new_yb = repartition(1, yb, NY, spec.wy_max)
        else:
            new_xb, new_yb = xb, yb

        new_state = FluidState(
            pid=pid, ptype=ptype, mass=mass,
            position=new_pos, velocity=new_vel, colour=colour, alive=alive,
        )
        total_spawn = spec.scene.total_spawn
        spawned = jax.lax.psum(
            jnp.asarray(total_spawn, jnp.int32) - src_dropped, (AXX, AXY))
        stats = dict(
            alive_count=jnp.sum(alive).astype(jnp.int32)[None],
            extent_ok=extent_ok.astype(jnp.int32)[None],
            migrate_dropped=migrate_dropped.astype(jnp.int32)[None],
            migrate_deferred=migrate_deferred[None],
            ghost_dropped=ghost_dropped[None],
            ghost_peak=ghost_peak[None],
            spawn_dropped=(jnp.asarray(total_spawn, jnp.int32) - spawned)[None],
            query_overflow=q_overflow[None],
            query_ids=q_ids,
            query_counts=q_counts,
        )
        if mesh_out is not None:
            stats.update(
                mesh_vs=mesh_out[0], mesh_ns=mesh_out[1], mesh_cs=mesh_out[2],
                tri_count=mesh_out[3][None],
                mc_emit_overflow=mesh_out[4][None],
            )
        return new_state, stats, new_xb, new_yb

    both = (AXX, AXY)
    state_specs = FluidState(
        pid=P(both), ptype=P(both), mass=P(both),
        position=P(None, both), velocity=P(None, both), colour=P(None, both),
        alive=P(both),
    )
    dyn_specs = dict(
        dt=P(), min_bound=P(), max_bound=P(), constant_force=P(),
        mc_isolevel=P(), mc_particle_size=P(), mc_particle_influence=P(),
    )
    scn_specs = dict(
        wells_centre=P(), wells_force=P(), src_centre=P(), src_velocity=P(),
        src_colour=P(), src_tag=P(), drain_centre=P(), drain_width=P(),
        q_point=P(), q_id=P(),
    )
    stats_specs = dict(
        alive_count=P(both), extent_ok=P(both),
        migrate_dropped=P(both), migrate_deferred=P(both),
        ghost_dropped=P(both), ghost_peak=P(both),
        spawn_dropped=P(both),
        query_overflow=P(both), query_ids=P(), query_counts=P(),
    )
    if spec.surface is not None:
        stats_specs.update(
            mesh_vs=P(None, both), mesh_ns=P(None, both),
            mesh_cs=P(None, both), tri_count=P(both),
            mc_emit_overflow=P(both),
        )

    fn = jax.jit(jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(state_specs, dyn_specs, scn_specs, P(), P()),
        out_specs=(state_specs, stats_specs, P(), P()),
        check_vma=False,
    ))

    from pbf_sph_tpu.models.jax_solver import scene_arrays_of

    empty_scn = scene_arrays_of(Scene(), spec.scene, np.dtype(spec.dtype))
    has_scene = (
        spec.scene.n_wells or spec.scene.total_spawn or spec.scene.n_drains
        or spec.scene.n_queries
    )
    xb0 = np.asarray(spec.xb, np.int32)
    yb0 = np.asarray(spec.yb, np.int32)

    def step(state, dyn, scn=None, bounds=None):
        """One 2D-tile frame.  Fixed mode (spec.rebalance=False): bounds may
        be omitted and the return is (state, stats).  Rebalance mode: pass
        the current (xb, yb) cut arrays (start from (spec.xb, spec.yb)) and
        the return is (state, stats, (new_xb, new_yb)) — thread the new cuts
        into the next call."""
        if scn is None:
            assert not has_scene, "spec has scene objects; pass scn arrays"
            scn = empty_scn
        if bounds is None:
            assert not spec.rebalance, (
                "rebalance mode: pass bounds=(xb, yb) (start from "
                "(spec.xb, spec.yb)) and thread the returned cuts into the "
                "next step"
            )
            bounds = (xb0, yb0)
        out_state, out_stats, nxb, nyb = fn(state, dyn, scn, bounds[0],
                                            bounds[1])
        if spec.rebalance:
            return out_state, out_stats, (nxb, nyb)
        return out_state, out_stats

    return step


def _queries_2d(spec: Shard2DSpec, scn, mx, my, bx, by, xb, yb, pid, ptype,
                alive, cell_table, min_extent, dtype):
    """Point queries over the owning tile's centre cell, merged across the
    2D mesh (reference `src/omp/ompsph.hpp:167-186` incl. the Morton
    guard)."""
    from pbf_sph_tpu.ops.curves import morton_encode3

    sc = spec.scene
    qcap = sc.query_capacity
    overflow = jnp.asarray(0, jnp.int32)
    if sc.n_queries == 0:
        return (jnp.zeros((0, qcap), jnp.int32), jnp.zeros((0,), jnp.int32),
                overflow)
    lgrid = spec.grid_local
    lnx, lny, lnz = lgrid.dims
    gnx, gny, gnz = spec.grid_global.dims
    gmaxz = spec.grid_global.maxz
    out_ids, out_counts = [], []
    for qi in range(sc.n_queries):
        scaled = scn["q_point"][qi] / jnp.asarray(spec.scale, dtype) - min_extent
        qcell = jnp.trunc(scaled / jnp.asarray(spec.h, dtype)).astype(jnp.int32)
        gdims = jnp.asarray([gnx, gny, gnz], jnp.int32)
        in_range = ((qcell >= 0) & (qcell < gdims)).all()
        safe = jnp.where(in_range, qcell, 0)
        zq = morton_encode3(safe[0], safe[1], safe[2])
        ok = in_range & (zq < gmaxz) & (zq + 1 < gmaxz)
        ox = _owner_of(xb, safe[0], spec.nx)
        oy = _owner_of(yb, safe[1], spec.ny)
        mine = ok & (ox == mx) & (oy == my)
        lx = safe[0] - bx + 1
        ly = safe[1] - by + 1
        lin = jnp.where(mine, (lx * lny + ly) * lnz + safe[2], 0)
        start = jnp.where(mine, cell_table[lin], 0)
        end = jnp.where(mine, cell_table[lin + 1], 0)
        idx = start + jnp.arange(qcap, dtype=jnp.int32)
        m = idx < end
        idxc = jnp.where(m, idx, 0)
        keep = m & (ptype[idxc] == FLUID) & alive[idxc]
        ids_local = jnp.where(keep, pid[idxc] + 1, 0)
        out_ids.append(jax.lax.psum(ids_local, (AXX, AXY)) - 1)
        out_counts.append(
            jax.lax.psum(jnp.sum(keep).astype(jnp.int32), (AXX, AXY)))
        overflow = jnp.maximum(overflow, jnp.where(mine, (end - start) - qcap, 0))
    return jnp.stack(out_ids), jnp.stack(out_counts), jnp.maximum(overflow, 0)


def make_mesh2d(nx: int, ny: int) -> Mesh:
    devices = np.array(jax.devices()[: nx * ny]).reshape(nx, ny)
    return Mesh(devices, (AXX, AXY))


def distribute_particles_2d(soa, spec: Shard2DSpec, dtype=np.float32,
                            bounds=None) -> FluidState:
    """Assign particles to tiles by (x, y) cell and build the concatenated
    per-device state (x-major tile order, matching make_mesh2d).  `bounds`
    defaults to the spec's cuts; pass a resumed (xb, yb) pair when restoring
    a rebalanced run so ownership matches the dynamic cuts."""
    f = dtype
    xb, yb = bounds if bounds is not None else (spec.xb, spec.yb)
    scale = np.float32(spec.scale)
    h = np.float32(spec.h)
    me = np.asarray(spec.min_bound, np.float32) / scale - h * 2
    gcx = np.trunc((soa.position[:, 0].astype(f) / scale - me[0]) / h).astype(np.int64)
    gcy = np.trunc((soa.position[:, 1].astype(f) / scale - me[1]) / h).astype(np.int64)
    ox = np.clip(np.searchsorted(xb, np.clip(gcx, 0, None), side="right") - 1,
                 0, spec.nx - 1)
    oy = np.clip(np.searchsorted(yb, np.clip(gcy, 0, None), side="right") - 1,
                 0, spec.ny - 1)
    from pbf_sph_tpu.core.types import FluidState as FS, ParticleSoA

    states = []
    for dx in range(spec.nx):
        for dy in range(spec.ny):
            idx = np.nonzero((ox == dx) & (oy == dy))[0]
            if len(idx) > spec.cap_local:
                raise ValueError(
                    f"tile ({dx},{dy}): {len(idx)} particles > cap {spec.cap_local}")
            sub = ParticleSoA(
                soa.pid[idx], soa.ptype[idx], soa.mass[idx],
                soa.position[idx], soa.velocity[idx], soa.colour[idx],
            )
            states.append(FS.from_soa(sub, spec.cap_total, f))
    return FluidState(
        pid=np.concatenate([s.pid for s in states]),
        ptype=np.concatenate([s.ptype for s in states]),
        mass=np.concatenate([s.mass for s in states]),
        position=np.concatenate([s.position for s in states], axis=1),
        velocity=np.concatenate([s.velocity for s in states], axis=1),
        colour=np.concatenate([s.colour for s in states], axis=1),
        alive=np.concatenate([s.alive for s in states]),
    )


def shard_state_2d(state: FluidState, mesh: Mesh) -> FluidState:
    from jax.sharding import NamedSharding

    both = (AXX, AXY)

    def put(a, spec):
        return jax.device_put(a, NamedSharding(mesh, spec))

    return FluidState(
        pid=put(state.pid, P(both)),
        ptype=put(state.ptype, P(both)),
        mass=put(state.mass, P(both)),
        position=put(state.position, P(None, both)),
        velocity=put(state.velocity, P(None, both)),
        colour=put(state.colour, P(None, both)),
        alive=put(state.alive, P(both)),
    )
