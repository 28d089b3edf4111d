"""Multi-chip domain decomposition: shard_map + ppermute halo exchange.

New capability beyond the reference (which is strictly single-device; see
SURVEY.md §2.3): the particle set is decomposed into x-axis slabs over a 1D
`jax.sharding.Mesh` axis ("x").  Each device owns the particles inside its
slab; each step

  1. advects locally,
  2. migrates particles whose new cell crossed a slab boundary to the
     neighbouring device (fixed-capacity send buffers over `ppermute`),
  3. exchanges one-cell-deep ghost layers with both neighbours,
  4. runs the PBF constraint solve locally, re-exchanging the ghost layer's
     lambda and pStar every solver iteration, so owned particles see exactly
     the same neighbourhoods as a single-device run (results match a
     single-chip run to fp tolerance).

The decomposition assumes the interaction radius h equals one grid cell, so a
one-cell ghost layer is sufficient — the same property the reference's 27-cell
stencil relies on (`src/sph.hpp:216-236`).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict

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

AXIS = "x"


@dataclass(frozen=True)
class ShardSpec:
    n_dev: int
    cap_local: int        # owned-particle capacity per device
    ghost_cap: int        # ghost slots per side
    migrate_cap: int      # migration slots per direction per step
    slab_w: int           # owned cells per device along x (fixed mode / max)
    grid_global: GridSpec
    h: float
    scale: float
    iteration: int
    cell_capacity: int
    dtype: str = "float32"
    scene: SceneSpec = SceneSpec()
    # initial-bounds min x (world space); used only by distribute_particles
    min_bound_x: float = 0.0
    # LOCAL marching-cubes spec (slab_w*res+1 node columns); None = no surface
    surface: object = None
    # Dynamic slab rebalancing (SURVEY hard part #4): slab boundaries are a
    # (n_dev+1,) x-column array re-partitioned from the global particle
    # x-CDF every frame, instead of fixed slab_w-wide slabs (under the
    # sloshing benchmark motion one fixed slab holds most of the fluid).
    # Boundary movement is
    # clamped to rebalance_step columns/frame and slabs keep >= min_slab_w
    # columns, which preserves the one-slab-hop migration invariant.
    # Incompatible with `surface` (the slab-local MC node partition is
    # static).
    rebalance: bool = False
    # max boundary movement per frame: 1 column keeps the worst-case single-
    # frame ownership change to one column's population (a 2-column move of
    # a dense band measured a sender-side migration burst above cap_local)
    rebalance_step: int = 1
    min_slab_w: int = 3       # minimum slab width (columns)
    # maximum slab width (columns, rebalance mode).  Bounds the static local
    # grid (and the per-device cell table) to (cap+1) columns instead of the
    # worst case gx - (n_dev-1)*min_slab_w; equal-count slabs sit near
    # gx/n_dev wide, so 0 = default 3x uniform width (clamped feasible).
    max_slab_cap: int = 0

    @property
    def grid_local(self) -> GridSpec:
        gx, gy, gz = self.grid_global.dims
        # local grid: slab columns + one ghost column each side.  Under
        # rebalancing a slab can grow up to the whole domain minus the other
        # devices' minimum widths, so the static local grid is sized for that
        # maximum; the dense cell table is O(ncells) ints — cheap.
        w = self.max_slab_w
        return GridSpec(
            extent=(w + 1, gy - 1, gz - 1),
            maxz=self.grid_global.maxz,
            quirks=False,
        )

    @property
    def max_slab_w(self) -> int:
        if not self.rebalance:
            return self.slab_w
        gx = self.grid_global.dims[0]
        cap = self.max_slab_cap or -(-3 * gx // self.n_dev)
        cap = max(cap, self.min_slab_w, -(-gx // self.n_dev))
        return min(cap, gx - (self.n_dev - 1) * self.min_slab_w)

    def uniform_bounds(self) -> np.ndarray:
        """Fixed-mode slab boundaries: [0, slab_w, 2*slab_w, ..., gx]."""
        gx = self.grid_global.dims[0]
        b = np.minimum(np.arange(self.n_dev + 1) * self.slab_w, gx)
        b[-1] = gx
        return b.astype(np.int32)

    def initial_bounds(self, soa) -> np.ndarray:
        """Equal-count boundaries from a host-side particle histogram (the
        rebalance criterion applied to the initial state)."""
        if not self.rebalance:
            return self.uniform_bounds()
        gx = self.grid_global.dims[0]
        scale = np.float32(self.scale)
        h = np.float32(self.h)
        min_ext_x = np.float32(self.min_bound_x) / scale - h * 2
        gcx = np.trunc(
            (soa.position[:, 0].astype(np.float32) / scale - min_ext_x) / h
        ).astype(np.int64)
        hist = np.bincount(np.clip(gcx, 0, gx - 1), minlength=gx)
        cdf = np.cumsum(hist)
        total = int(cdf[-1])
        mw, xw = self.min_slab_w, self.max_slab_w
        b = [0]
        for d in range(1, self.n_dev):
            target = total * d / self.n_dev
            v = int(np.searchsorted(cdf, target, side="left")) + 1
            v = min(max(v, b[-1] + mw, gx - xw * (self.n_dev - d)),
                    gx - mw * (self.n_dev - d), b[-1] + xw)
            b.append(v)
        b.append(gx)
        return np.asarray(b, np.int32)

    @property
    def cap_total(self) -> int:
        return self.cap_local + 2 * self.ghost_cap

    @staticmethod
    def create(config, n_dev: int, count: int, h: float,
               cell_capacity: int = 48, dtype: str = "float32",
               cap_local: int = 0, scene: Scene = None,
               rebalance: bool = False, ghost_cap: int = 0,
               min_slab_w: int = 3) -> "ShardSpec":
        grid = GridSpec.from_bounds(config.min_bound, config.max_bound, config.scale, h)
        gx = grid.dims[0]
        slab_w = -(-gx // n_dev)
        sspec = scene_spec_of(scene or Scene(), config)
        if rebalance and config.surface is not None:
            # the MC node partition follows the DYNAMIC slab bounds, so the
            # per-column node offset bounds[d]*res must be a whole node index
            # for every possible boundary column
            if not float(config.surface.resolution).is_integer():
                raise ValueError(
                    "rebalance + surface requires an integer MC resolution "
                    "(the dynamic node partition shifts by whole columns)")
        if rebalance and gx < n_dev * min_slab_w:
            raise ValueError(
                f"rebalance: grid has {gx} x-columns but {n_dev} slabs of "
                f">= {min_slab_w} columns need {n_dev * min_slab_w} — use "
                f"fewer devices, a finer grid (smaller scale), or a smaller "
                f"min_slab_w"
            )
        if cap_local <= 0 and rebalance:
            # equal-count boundaries keep every slab near count/n_dev; 2.5x
            # headroom absorbs the residual imbalance between rebalances
            # (zero-drop validated over 200 sloshing frames in
            # tests/test_sharded.py::test_rebalance_sloshing)
            per = (count + sspec.total_spawn) / n_dev
            cap_local = max(256, -(-int(per * 2.5) // 128) * 128)
        if cap_local <= 0:
            # fixed slabs: whole-set default.  Under the sloshing benchmark
            # motion the peak slab holds most of the particles in steady
            # state and the INITIAL dam column can sit entirely inside one
            # slab, so a fraction-of-count cap saves little at real risk.  Balanced decompositions can pass an explicit
            # cap_local, and rebalance=True sizes it from the equal-count
            # partition instead.
            cap_local = max(256, -(-int(count + sspec.total_spawn) // 128) * 128)
        gy, gz = grid.dims[1], grid.dims[2]
        if ghost_cap <= 0:
            # worst-case default: 8 particles per boundary-column cell.  Real
            # boundary columns hold far less; callers that know the workload
            # can pass a tighter ghost_cap (overflow is counted in
            # ghost_dropped either way)
            ghost_cap = max(128, -(-(gy * gz * 8) // 128) * 128)
        ghost_cap = min(ghost_cap, cap_local)
        # under rebalancing a boundary move hands a whole column (plus the
        # usual drift) to a neighbour in one frame; size the migration
        # buffers generously (they are transient ppermute payloads)
        migrate_cap = cap_local if rebalance else min(
            cap_local, max(128, ghost_cap)
        )
        spec = ShardSpec(
            n_dev=n_dev,
            cap_local=cap_local,
            ghost_cap=ghost_cap,
            migrate_cap=migrate_cap,
            slab_w=slab_w,
            grid_global=grid,
            h=h,
            scale=float(config.scale),
            iteration=int(config.iteration),
            cell_capacity=cell_capacity,
            dtype=dtype,
            scene=sspec,
            min_bound_x=float(np.asarray(config.min_bound, np.float32)[0]),
            surface=None,
            rebalance=rebalance,
            min_slab_w=min_slab_w,
        )
        if config.surface is not None:
            from pbf_sph_tpu.ops.mc import McSpec, default_cube_cap

            res = float(config.surface.resolution)
            # static local lattice sized for the WIDEST possible slab — the
            # max_slab_w property is the single source of truth (fixed mode:
            # slab_w; rebalance: the max_slab_cap-aware width cap); the
            # dynamic bounds mask the owned cube range per frame
            w_nodes = spec.max_slab_w
            nodes_x = w_nodes * res
            assert nodes_x == int(nodes_x), (
                "sharded MC requires slab_w * resolution to be integral"
            )
            gspec = McSpec.from_extent(grid.extent, res)
            local_sample = (int(nodes_x) + 1, gspec.sample[1], gspec.sample[2])
            local_vol = int(np.prod([s - 1 for s in local_sample]))
            surface = dataclasses.replace(
                gspec,
                sample=local_sample,
                tri_capacity=max(1024, -(-gspec.tri_capacity // n_dev) * 2),
                # compaction cap from the LOCAL march volume (the per-slab
                # lattice this device actually extracts from)
                cube_cap=default_cube_cap(local_vol),
            )
            spec = dataclasses.replace(spec, surface=surface)
        return spec


def _equal_count_target(total, d: int, n: int):
    """floor(total * d / n) without the int32-overflowing product.

    `total` is a traced int32 particle count (fits by construction); the
    naive `total * d` wraps beyond ~2^31/n, and jnp int64 silently truncates
    to int32 unless jax_enable_x64 is on, so widening is NOT a fix.
    Decompose total = q*n + r: floor(total*d/n) = q*d + (r*d)//n exactly,
    with every intermediate < 2^31 (q*d <= total, r*d < n^2)."""
    q, r = total // n, total % n
    return q * d + (r * d) // n


def _perm(n: int, shift: int):
    """ppermute pairs sending each device d to d+shift (non-periodic)."""
    return [(d, d + shift) for d in range(n) if 0 <= d + shift < n]


def _owner_of_col(bounds, gcx, n_dev):
    """Owning device of global x-column gcx under slab boundaries `bounds`
    ((n_dev+1,) ascending, bounds[0]=0, bounds[-1]=gx)."""
    o = jnp.searchsorted(bounds, gcx, side="right").astype(jnp.int32) - 1
    return jnp.clip(o, 0, n_dev - 1)


def _sharded_queries(spec: ShardSpec, scn, me, b_me, bounds, pid, ptype, alive,
                     cells_l, cell_table, min_extent, dtype):
    """Point queries over the owning device's centre cell (reference
    `src/omp/ompsph.hpp:167-186` incl. the Morton-guard quirk), merged across
    the mesh.  Returns replicated (n_queries, qcap) ids and (n_queries,)
    counts."""
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
    D = spec.n_dev
    out_ids, out_counts = [], []
    for qi in range(sc.n_queries):
        scaled = scn["q_point"][qi] / jnp.asarray(spec.scale, dtype) - min_extent
        qcell = jnp.trunc(scaled / jnp.asarray(spec.h, dtype)).astype(jnp.int32)
        gdims = jnp.asarray([gnx, gny, gnz], jnp.int32)
        in_range = ((qcell >= 0) & (qcell < gdims)).all()
        safe = jnp.where(in_range, qcell, 0)
        # reference Morton-table guard (single-chip `_queries` parity)
        zq = morton_encode3(safe[0], safe[1], safe[2])
        ok = in_range & (zq < gmaxz) & (zq + 1 < gmaxz)
        owner = _owner_of_col(bounds, safe[0], D)
        mine = ok & (owner == me)
        lx = safe[0] - b_me + 1                      # owned local columns 1..w_me
        lin = jnp.where(mine, (lx * lny + safe[1]) * lnz + safe[2], 0)
        start = jnp.where(mine, cell_table[lin], 0)
        end = jnp.where(mine, cell_table[lin + 1], 0)
        idx = start + jnp.arange(qcap, dtype=jnp.int32)
        m = idx < end
        idxc = jnp.where(m, idx, 0)
        keep = m & (ptype[idxc] == FLUID) & alive[idxc]
        ids_local = jnp.where(keep, pid[idxc] + 1, 0)    # id+1 protocol
        out_ids.append(jax.lax.psum(ids_local, AXIS) - 1)
        out_counts.append(
            jax.lax.psum(jnp.sum(keep).astype(jnp.int32), AXIS)
        )
        overflow = jnp.maximum(
            overflow, jnp.where(mine, (end - start) - qcap, 0)
        )
    return jnp.stack(out_ids), jnp.stack(out_counts), jnp.maximum(overflow, 0)


def _compact_first(flag, cap: int):
    """Indices of the first `cap` rows where flag is True (padded with the
    remaining rows); returns (idx (cap,), valid (cap,))."""
    order = jnp.argsort(~flag, stable=True)
    idx = order[:cap]
    return idx, flag[idx]


def build_sharded_step(spec: ShardSpec, mesh: Mesh):
    """Returns step(state, dyn, scn=None) -> (state, stats); state arrays are
    sharded along their last axis (capacity) over mesh axis AXIS.  Runs the
    FULL per-frame pipeline of the single-chip step — sources, drains, wells,
    advect, migration, ghost exchange, diffuse + constraint solve (via the
    shared `neighbour_phases` pipeline), queries, finalise."""
    dtype = jnp.dtype(spec.dtype)
    D = spec.n_dev
    CL = spec.cap_local
    H = spec.ghost_cap
    M = spec.migrate_cap
    CT = spec.cap_total
    K = spec.cell_capacity
    lgrid = spec.grid_local
    gny, gnz = spec.grid_global.dims[1], spec.grid_global.dims[2]

    local_spec = StepSpec(
        capacity=CT, cell_capacity=K, grid=lgrid, h=spec.h, scale=spec.scale,
        iteration=spec.iteration, dtype=spec.dtype, scene=spec.scene,
        surface=None,
    )

    def local_step(state: FluidState, dyn: Dict[str, Any], scn: Dict[str, Any],
                   bounds):
        me = jax.lax.axis_index(AXIS)
        b_me = bounds[me]
        w_me = bounds[me + 1] - b_me
        h = spec.h
        scale = jnp.asarray(spec.scale, dtype)
        dt = dyn["dt"].astype(dtype)
        min_bound = dyn["min_bound"].astype(dtype)
        max_bound = dyn["max_bound"].astype(dtype)
        padding = jnp.asarray(h, dtype) * 2
        min_extent = min_bound / scale - padding
        # per-frame extent guard (mirrors the single-chip step,
        # models/jax_solver.py): dt/bounds/forces are jit-dynamic, but the
        # GLOBAL grid was compiled from the initial bounds — a scaled or
        # resized domain must fail loudly instead of silently mis-gridding
        # 1e-3-cell slack: see the single-chip guard (jax_solver.py) — ULP
        # jitter between reciprocal-multiply and host division flips trunc a
        # whole cell when span/h sits on an integer boundary
        needed = jnp.trunc(
            ((max_bound / scale + padding) - min_extent) / jnp.asarray(h, dtype)
            - jnp.asarray(1e-3, dtype)
        ).astype(jnp.int32)
        extent_ok = jnp.all(
            needed <= jnp.asarray(spec.grid_global.extent, jnp.int32)
        )

        # ghost slots (tail 2H rows) always start dead
        alive = state.alive.at[CL:].set(False)
        state = dataclasses.replace(state, alive=alive)

        def owner_of_x(px_world):
            gcx = jnp.trunc(
                jnp.clip(
                    (px_world / scale - min_extent[0]) / jnp.asarray(h, dtype),
                    -2e9, 2e9,
                )
            ).astype(jnp.int32)
            return _owner_of_col(bounds, gcx, D)

        # 0a. sources: only the device owning the spawn x-cell spawns
        state, src_dropped = _apply_sources(
            state, scn, local_spec, dtype,
            accept=lambda spawn_pos: owner_of_x(spawn_pos[0]) == me,
            slot_limit=CL,
        )
        # 0b. drains (position-based, purely local)
        state = _apply_drains(state, scn, local_spec)

        # 1. advect (wells are replicated force fields — purely local)
        vel, pstar = pbf.advect(
            state.position, state.velocity, state.mass, state.ptype, state.alive,
            scn["wells_centre"], scn["wells_force"],
            dyn["constant_force"].astype(dtype), dt, scale,
        )

        # 2. migration by global x-cell
        gcx = jnp.trunc(
            jnp.clip((pstar[0] - min_extent[0]) / jnp.asarray(h, dtype), -2e9, 2e9)
        ).astype(jnp.int32)
        owner = _owner_of_col(bounds, gcx, D)
        # one-slab hop per step (held by rebalance_step + min_slab_w under
        # rebalancing: boundaries move <= rebalance_step columns/frame and
        # slabs stay >= min_slab_w wide)
        owner = jnp.clip(owner, me - 1, me + 1)
        go_left = state.alive & (owner < me)
        go_right = state.alive & (owner > me)

        fields = dict(
            pid=state.pid, ptype=state.ptype, mass=state.mass,
            px=state.position[0], py=state.position[1], pz=state.position[2],
            vx=vel[0], vy=vel[1], vz=vel[2],
            cr=state.colour[0], cg=state.colour[1], cb=state.colour[2],
            ca=state.colour[3],
        )

        def pack(flag, cap):
            idx, valid = _compact_first(flag, cap)
            buf = {k: jnp.where(valid, v[idx], 0) for k, v in fields.items()}
            buf["valid"] = valid
            sent = jnp.zeros((CT,), bool).at[idx].set(valid)
            return buf, sent

        send_l, sent_l = pack(go_left, M)
        send_r, sent_r = pack(go_right, M)
        # emigrants beyond the send capacity are RETAINED (alive, deferred to
        # the next frame) instead of silently vanishing; they sit outside the
        # local grid for one frame (sort_key marks them non-member, so they
        # skip interactions) and are counted in migrate_deferred
        unsent = (go_left & ~sent_l) | (go_right & ~sent_r)
        migrate_deferred = jnp.sum(unsent).astype(jnp.int32)
        alive = state.alive & ((owner == me) | unsent)

        recv_from_r = jax.tree.map(
            lambda x: jax.lax.ppermute(x, AXIS, _perm(D, -1)), send_l
        )
        recv_from_l = jax.tree.map(
            lambda x: jax.lax.ppermute(x, AXIS, _perm(D, +1)), send_r
        )

        # merge immigrants into dead owned slots
        def merge(alive, vel, pstar, recv):
            nonlocal fields
            slots_idx, _ = _compact_first(~alive[:CL], M)
            can = (~alive[slots_idx]) & recv["valid"]
            upd = {}
            for k in fields:
                upd[k] = fields[k].at[slots_idx].set(
                    jnp.where(can, recv[k].astype(fields[k].dtype), fields[k][slots_idx])
                )
            fields = upd
            alive = alive.at[slots_idx].set(alive[slots_idx] | can)
            migrate_dropped = jnp.sum(recv["valid"]) - jnp.sum(can)
            return alive, migrate_dropped

        alive, drop_r = merge(alive, vel, pstar, recv_from_r)
        alive, drop_l = merge(alive, vel, pstar, recv_from_l)

        # rebuild vectors after merge; immigrants recompute pstar from v/pos
        position = jnp.stack([fields["px"], fields["py"], fields["pz"]])
        vel = jnp.stack([fields["vx"], fields["vy"], fields["vz"]])
        colour = jnp.stack([fields["cr"], fields["cg"], fields["cb"], fields["ca"]])
        ptype = fields["ptype"]
        pid = fields["pid"]
        mass = fields["mass"]
        fluid = (ptype == FLUID) & alive
        pstar = jnp.stack(
            [
                jnp.where(fluid, vel[a] * dt + position[a] / scale, position[a] / scale)
                for a in range(3)
            ]
        )

        # 3. ghost layer exchange (one-cell-deep boundary columns)
        gcx = jnp.trunc(
            jnp.clip((pstar[0] - min_extent[0]) / jnp.asarray(h, dtype), -2e9, 2e9)
        ).astype(jnp.int32)
        lcx = gcx - b_me  # owned columns are [0, w_me)
        bl = alive & (lcx == 0)
        br = alive & (lcx == w_me - 1)
        idx_bl, val_bl = _compact_first(bl, H)
        idx_br, val_br = _compact_first(br, H)

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

        ghost_to_l = ghost_pack(idx_bl, val_bl)  # our left boundary -> left nbr
        ghost_to_r = ghost_pack(idx_br, val_br)  # our right boundary -> right nbr
        # what we RECEIVE from the left is the left neighbour's RIGHT boundary
        ghost_from_l = jax.tree.map(
            lambda x: jax.lax.ppermute(x, AXIS, _perm(D, +1)), ghost_to_r
        )
        ghost_from_r = jax.tree.map(
            lambda x: jax.lax.ppermute(x, AXIS, _perm(D, -1)), ghost_to_l
        )

        # install ghosts in the tail slots [CL, CL+2H)
        def install(ghost, lo):
            nonlocal pstar, mass, ptype, colour, alive, position
            sl = slice(lo, lo + H)
            pstar = pstar.at[0, sl].set(ghost["px"]).at[1, sl].set(ghost["py"]).at[2, sl].set(ghost["pz"])
            position = position.at[0, sl].set(ghost["posx"]).at[1, sl].set(ghost["posy"]).at[2, sl].set(ghost["posz"])
            mass = mass.at[sl].set(ghost["mass"].astype(dtype))
            ptype = ptype.at[sl].set(ghost["ptype"])
            colour = (
                colour.at[0, sl].set(ghost["cr"]).at[1, sl].set(ghost["cg"])
                .at[2, sl].set(ghost["cb"]).at[3, sl].set(ghost["ca"])
            )
            alive = alive.at[sl].set(ghost["valid"])

        install(ghost_from_l, CL)        # ghosts on our left edge
        install(ghost_from_r, CL + H)    # ghosts on our right edge

        # 4. local sort over the local grid (owned + ghost columns)
        from pbf_sph_tpu.ops.grid import cell_coords, sort_key

        cells_g = cell_coords(pstar, min_extent, h)
        cells_l = (cells_g[0] - b_me + 1, cells_g[1], cells_g[2])
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

        # sorted positions of the ghost slots + of our boundary particles
        ghost_pos_l = inv[CL : CL + H]
        ghost_pos_r = inv[CL + H : CL + 2 * H]
        bpos_l = inv[idx_bl]
        bpos_r = inv[idx_br]

        # 4b. point queries: the owning device scans its centre cell, results
        # are merged across the mesh with a psum (id+1 protocol: non-owners
        # contribute 0, empty slots decode back to -1)
        q_ids, q_counts, q_overflow = _sharded_queries(
            spec, scn, me, b_me, bounds, pid, ptype, alive, cells_l, cell_table,
            min_extent, dtype,
        )

        # 5-6. diffuse + constraint solve — the single-chip phase pipeline
        # with per-iteration halo hooks
        def refresh(arr1d):
            to_l = arr1d[bpos_l]
            to_r = arr1d[bpos_r]
            from_l = jax.lax.ppermute(to_r, AXIS, _perm(D, +1))
            from_r = jax.lax.ppermute(to_l, AXIS, _perm(D, -1))
            # our left-edge ghosts came from left neighbour's right boundary
            arr1d = arr1d.at[ghost_pos_l].set(
                jnp.where(ghost_from_l["valid"], from_l, arr1d[ghost_pos_l])
            )
            arr1d = arr1d.at[ghost_pos_r].set(
                jnp.where(ghost_from_r["valid"], from_r, arr1d[ghost_pos_r])
            )
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
        new_pos, new_vel = pbf.finalise(position, vel, pstar, ptype, alive, dt, scale, dtype)

        # 7b. marching cubes over the local slab's lattice nodes (ghosts still
        # alive: boundary nodes gather from the ghost column; cubes partition
        # exactly across slabs — no duplicate triangles)
        mesh_out = None
        if spec.surface is not None:
            from pbf_sph_tpu.ops import mc as mc_ops

            res = spec.surface.resolution
            if spec.rebalance:
                # the node partition follows the DYNAMIC slab bounds: this
                # device evaluates nodes [bounds[me]*res, bounds[me+1]*res]
                # (the static local lattice is sized for the widest slab;
                # padding nodes feed only masked cubes) and owns cubes with
                # global x < bounds[me+1]*res.  Ghost columns at bounds[me]-1
                # and bounds[me+1] supply exactly the particles the edge
                # nodes gather — the same invariant as fixed slabs.
                res_i = int(res)
                node_off = (b_me * res_i, 0, 0)
                cube_hi = bounds[me + 1] * res_i
                cell_x0 = b_me
            else:
                nodes_x_owned = spec.surface.sample[0] - 1  # slab_w * res
                node_off = (me * nodes_x_owned, 0, 0)
                cube_hi = None
                cell_x0 = me * spec.slab_w
            cell_off = (-(cell_x0 - 1), 0, 0)
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
                node_offset=node_off, cube_x_hi=cube_hi,
            )
            mesh_out = (vs, ns, cs, total, emit_ovf)

        # drop ghosts
        ghost_mask = jnp.zeros((CT,), bool).at[CL:].set(True)[order]
        alive = alive & ~ghost_mask

        # compact alive rows to the front: the cell sort above can strand
        # owned particles in the tail region [CL:), which the next step
        # reserves for ghosts (start-of-step kill + install overwrite) — an
        # uncounted particle-loss path whenever owned + ghosts > CL (hit by
        # the rebalance sloshing test's fractional cap_local)
        order2 = jnp.argsort(~alive, stable=True)
        pid, ptype, mass, alive = (
            pid[order2], ptype[order2], mass[order2], alive[order2]
        )
        new_pos = new_pos[:, order2]
        new_vel = new_vel[:, order2]
        colour = colour[:, order2]

        # 8. slab rebalancing: re-partition the boundaries from the global
        # particle x-CDF (one (gx,) psum per frame).  Movement is clamped to
        # rebalance_step columns and widths to >= min_slab_w, so ownership
        # changes stay within the one-slab-hop migration budget.
        if spec.rebalance:
            gxn = spec.grid_global.dims[0]
            gcx_fin = jnp.trunc(
                jnp.clip((new_pos[0] / scale - min_extent[0]) / jnp.asarray(h, dtype),
                         -2e9, 2e9)
            ).astype(jnp.int32)
            histl = jnp.zeros((gxn,), jnp.int32).at[
                jnp.clip(gcx_fin, 0, gxn - 1)
            ].add(alive.astype(jnp.int32))
            # int32-safe equal-count targets (see _equal_count_target)
            cdf = jnp.cumsum(jax.lax.psum(histl, AXIS))
            total = cdf[-1]
            S = spec.rebalance_step
            MW = spec.min_slab_w
            XW = spec.max_slab_w
            bs = [jnp.asarray(0, jnp.int32)]
            for d in range(1, D):
                target = _equal_count_target(total, d, D)
                raw = jnp.searchsorted(cdf, target, side="left").astype(jnp.int32) + 1
                v = jnp.clip(raw, bounds[d] - S, bounds[d] + S)
                # width bounds: [MW, XW] for this slab, feasibility for the
                # rest (these clips induce moves <= S given the previous
                # bounds satisfied the same width constraints)
                v = jnp.clip(v, jnp.maximum(bs[-1] + MW, gxn - XW * (D - d)),
                             jnp.minimum(gxn - MW * (D - d), bs[-1] + XW))
                bs.append(v)
            bs.append(jnp.asarray(gxn, jnp.int32))
            new_bounds = jnp.stack(bs)
        else:
            new_bounds = bounds

        new_state = FluidState(
            pid=pid, ptype=ptype, mass=mass,
            position=new_pos, velocity=new_vel, colour=colour, alive=alive,
        )
        total_spawn = spec.scene.total_spawn
        spawned = jax.lax.psum(
            jnp.asarray(total_spawn, jnp.int32) - src_dropped, AXIS
        )
        stats = dict(
            alive_count=jnp.sum(alive).astype(jnp.int32)[None],
            extent_ok=extent_ok.astype(jnp.int32)[None],
            migrate_dropped=(drop_l + drop_r).astype(jnp.int32)[None],
            migrate_deferred=migrate_deferred[None],
            ghost_dropped=(
                jnp.maximum(jnp.sum(bl) - H, 0) + jnp.maximum(jnp.sum(br) - H, 0)
            ).astype(jnp.int32)[None],
            # per-device peak boundary-layer occupancy this frame — the
            # number ghost_cap must cover (sizing evidence for users; the
            # CLI --multichip path prints it on overflow)
            ghost_peak=jnp.maximum(
                jnp.sum(bl), jnp.sum(br)
            ).astype(jnp.int32)[None],
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
        return new_state, stats, new_bounds

    state_specs = FluidState(
        pid=P(AXIS), ptype=P(AXIS), mass=P(AXIS),
        position=P(None, AXIS), velocity=P(None, AXIS), colour=P(None, AXIS),
        alive=P(AXIS),
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
        alive_count=P(AXIS), extent_ok=P(AXIS),
        migrate_dropped=P(AXIS), migrate_deferred=P(AXIS),
        ghost_dropped=P(AXIS), ghost_peak=P(AXIS),
        spawn_dropped=P(AXIS),
        query_overflow=P(AXIS), query_ids=P(), query_counts=P(),
    )
    if spec.surface is not None:
        stats_specs.update(
            mesh_vs=P(None, AXIS), mesh_ns=P(None, AXIS), mesh_cs=P(None, AXIS),
            tri_count=P(AXIS), mc_emit_overflow=P(AXIS),
        )

    fn = jax.jit(jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(state_specs, dyn_specs, scn_specs, P()),
        out_specs=(state_specs, stats_specs, P()),
        check_vma=False,
    ))

    from pbf_sph_tpu.models.jax_solver import scene_arrays_of

    empty_scn = scene_arrays_of(Scene(), spec.scene, np.dtype(spec.dtype))
    has_scene = (
        spec.scene.n_wells or spec.scene.total_spawn or spec.scene.n_drains
        or spec.scene.n_queries
    )
    uniform_b = spec.uniform_bounds()

    def step(state, dyn, scn=None, bounds=None):
        """One sharded frame.  Fixed mode (spec.rebalance=False): bounds may
        be omitted and the return is (state, stats).  Rebalance mode: pass
        the current boundaries (start from spec.initial_bounds(soa)) and the
        return is (state, stats, new_bounds) — thread new_bounds into the
        next call."""
        if scn is None:
            assert not has_scene, "spec has scene objects; pass scn arrays"
            scn = empty_scn
        if bounds is None:
            assert not spec.rebalance, (
                "rebalance mode: pass bounds (spec.initial_bounds(soa)) and "
                "thread the returned new_bounds into the next step"
            )
            bounds = uniform_b
        out_state, out_stats, out_bounds = fn(state, dyn, scn, bounds)
        if spec.rebalance:
            return out_state, out_stats, out_bounds
        return out_state, out_stats

    return step


def gather_mesh(stats, spec: ShardSpec):
    """Assemble the global triangle soup from a sharded step's per-device
    mesh segments (host-side): (vs, ns, cs) arrays of shape (3*T, 3|4)."""
    counts = np.asarray(stats["tri_count"]).ravel()
    cap3 = spec.surface.tri_capacity * 3
    outs = []
    for key_, w in (("mesh_vs", 3), ("mesh_ns", 3), ("mesh_cs", 4)):
        g = np.asarray(stats[key_])          # (w, n_dev*cap3)
        segs = [
            g[:, d * cap3 : d * cap3 + 3 * int(tc)].T
            for d, tc in enumerate(counts)
        ]
        outs.append(
            np.concatenate(segs) if segs else np.zeros((0, w), g.dtype)
        )
    return outs[0], outs[1], outs[2]


def shard_state(state: FluidState, mesh: Mesh) -> FluidState:
    """Place a host-built global state (capacity = n_dev * cap_total, already
    arranged per-device) onto the mesh."""
    from jax.sharding import NamedSharding

    def put(a, spec):
        return jax.device_put(a, NamedSharding(mesh, spec))

    return FluidState(
        pid=put(state.pid, P(AXIS)),
        ptype=put(state.ptype, P(AXIS)),
        mass=put(state.mass, P(AXIS)),
        position=put(state.position, P(None, AXIS)),
        velocity=put(state.velocity, P(None, AXIS)),
        colour=put(state.colour, P(None, AXIS)),
        alive=put(state.alive, P(AXIS)),
    )


def distribute_particles(soa, spec: ShardSpec, dtype=np.float32,
                         bounds=None) -> FluidState:
    """Assign particles to slabs by x-position and build the concatenated
    per-device state (host-side).  `bounds` defaults to the fixed uniform
    slabs; pass spec.initial_bounds(soa) for rebalance mode."""
    f = dtype
    scale = np.float32(spec.scale)
    h = np.float32(spec.h)
    if bounds is None:
        bounds = (spec.initial_bounds(soa) if spec.rebalance
                  else spec.uniform_bounds())
    # owner by current position's global x-cell (pre-advect approximation;
    # migration fixes any edge case on the first step)
    states = []
    min_ext_x = np.float32(spec.min_bound_x) / scale - h * 2
    gcx = np.trunc((soa.position[:, 0].astype(f) / scale - min_ext_x) / h).astype(np.int64)
    owner = np.clip(
        np.searchsorted(bounds, np.clip(gcx, 0, None), side="right") - 1,
        0, spec.n_dev - 1,
    )
    from pbf_sph_tpu.core.types import FluidState as FS, ParticleSoA

    for d in range(spec.n_dev):
        idx = np.nonzero(owner == d)[0]
        if len(idx) > spec.cap_local:
            raise ValueError(f"device {d}: {len(idx)} particles > cap {spec.cap_local}")
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
