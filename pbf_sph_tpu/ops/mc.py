"""Marching cubes — XLA path.

Re-design of the reference's three MC kernels
(mc_lattice `src/ocl/oclsph_kernel.h:176-263`, mc_size `:272-318`,
mc_eval `:336-408`): the lattice field is a dense gather over the particle
grid, the triangle count is an exclusive cumsum (replacing the workgroup tree
reduction), and emission scatters into a fixed-capacity buffer at
cumsum-derived offsets (replacing the global atomic counter — deterministic,
atomics-free, static shapes).

Layout: everything is component-major / leading-small-axis — lattice normals
(3, L), colours (4, L), corner values (8, M), edge lerps (12, M), output mesh
(3, 3T)/(4, 3T) — so the long axis is always the contiguous one.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import jax
import jax.numpy as jnp

from pbf_sph_tpu.core.types import OBSTACLE
from pbf_sph_tpu.ops import mc_tables as mct
from pbf_sph_tpu.ops.curves import morton_encode3


# initial staged-rows-per-block capacity for blocked emission (grown on
# emit_overflow, models/growth.py).  Stage 1 of the blocked two-stage sort
# still sorts all 15*M rows, just block-batched, so it does not cut the
# work; the default path keeps emit_block=0 and compacts cubes BEFORE
# emission instead (mc_extract docstring).
EMIT_CAP_DEFAULT = 1280

# cube-compaction defaults: the compacted path's output is bit-identical to
# the global sort's.  An eighth of the march volume covers live-cube
# fractions up to 12.5% (the mc512k dam break has ~4.5% live cubes) before
# the growth policy has to step in.  Below the volume threshold the lattice
# is small enough that the global sort is already cheap and not worth a
# growth-retry loop.
CUBE_COMPACT_MIN_VOL = 32768


def default_cube_cap(march_volume: int) -> int:
    if march_volume < CUBE_COMPACT_MIN_VOL:
        return 0
    return min(-(-(march_volume // 8) // 128) * 128, march_volume)


@dataclass(frozen=True)
class McSpec:
    """Static MC geometry derived from the grid extent and the (static)
    resolution: sampleSize = floor(extent*res)+1 (reference
    `src/omp/ompsph.hpp:283-284`)."""

    resolution: float
    sample: Tuple[int, int, int]
    tri_capacity: int
    # Blocked two-stage emission: compact each `emit_block`-cube
    # block's live vertex slots to the front with one row-sort over
    # (nblk, 15*B) blocks, keep the first `emit_cap` staged rows per block
    # (128-aligned; grown on emit_overflow), then merge with a short global
    # sort over nblk*emit_cap rows instead of 15*M.  emit_block=0 keeps the
    # single global sort (correct at any size, slower at scale — most of
    # the 15*M vertex slots it sorts are padding).
    emit_block: int = 0
    emit_cap: int = 0
    # Cube-compaction emission: one sort of the M per-cube rows by
    # (live ? idx : BIG+idx) — unique keys, deterministic — carrying the 65
    # per-cube corner operands, sliced to the first `cube_cap` columns; the
    # slot emission sort then runs over 15*cube_cap rows instead of 15*M.
    # Cutting rows 15x (stage 1) and ~5-10x (stage 2) is the at-scale lever
    # the blocked two-stage sort was not.
    # cube_cap=0 keeps the single global sort; overflow (more live cubes
    # than cube_cap) reports via emit_overflow (mesh INVALID — grow).
    cube_cap: int = 0

    @staticmethod
    def from_extent(extent, resolution: float, tri_capacity: int = 0,
                    cube_cap: int = -1) -> "McSpec":
        f = np.float32
        sample = (np.floor(np.asarray(extent, f) * f(resolution)) + 1).astype(np.int64)
        march = sample - 1
        vol = int(march[0] * march[1] * march[2])
        if tri_capacity <= 0:
            tri_capacity = max(1024, vol)  # ~1 triangle/cube on average
        if cube_cap < 0:
            cube_cap = default_cube_cap(vol)
        return McSpec(
            resolution=float(resolution),
            sample=tuple(int(v) for v in sample),
            tri_capacity=int(tri_capacity),
            cube_cap=int(cube_cap),
        )


def _node_grid(spec: McSpec):
    nx, ny, nz = spec.sample
    L = nx * ny * nz
    idx = jnp.arange(L, dtype=jnp.int32)
    x = idx // (ny * nz)
    rem = idx - x * (ny * nz)
    y = rem // nz
    z = rem - y * nz
    return (x, y, z)  # three (L,) int32


def mc_field(position, colour, ptype, alive, cell_table, grid, min_extent,
             extent, spec: McSpec, cap: int, h: float, scale,
             particle_size, particle_influence,
             node_offset=None, cell_offset=None, quirk_grid=None):
    """Metaball lattice field (reference `src/omp/ompsph.hpp:288-356`).

    Per node: gather particles within h*scale from the 27 cells around the
    node's (clamped) grid cell; accumulate v += size/len^infl, the analytic
    normal, and the mean colour.  Division-by-zero conventions (0-normal
    normalize, 0-count colour mean) intentionally reproduce the reference's
    NaN behaviour; those lattice entries are never consumed by emission.

    Multi-chip slab mode (parallel/sharded.py): `spec.sample` covers the
    LOCAL node range; `node_offset` (3 scalars, may be traced) maps local
    node indices to global ones for world positions / clamps / the far-corner
    skip, `cell_offset` maps global cell coords to the LOCAL grid's (for the
    ghost-column table lookups), and `quirk_grid` supplies the GLOBAL grid's
    Morton guard so single-chip quirks reproduce exactly.  Nodes whose global
    coords exceed the global sample (last-slab padding) are skipped.

    `position` (3,C), `colour` (4,C); returns (lat_v (L,), lat_n (3,L), lat_c (4,L)).
    """
    dtype = position.dtype
    node_local = _node_grid(spec)
    L = node_local[0].shape[0]
    res = jnp.asarray(spec.resolution, dtype)
    step = jnp.asarray(h, dtype) / res
    if node_offset is None:
        node = node_local
        pad_skip = jnp.zeros((L,), bool)
    else:
        node = tuple(
            node_local[a] + jnp.asarray(node_offset[a], jnp.int32) for a in range(3)
        )
        gs = [int(np.floor(extent[a] * spec.resolution)) + 1 for a in range(3)]
        pad_skip = (
            (node[0] >= gs[0]) | (node[1] >= gs[1]) | (node[2] >= gs[2])
        )
    a_world = [
        (min_extent[a] + node[a].astype(dtype) * step) * scale for a in range(3)
    ]  # three (L,)
    threshold = jnp.asarray(h, dtype) * scale

    node_cell = [jnp.trunc(node[a].astype(dtype) / res).astype(jnp.int32) for a in range(3)]
    skip = (
        (node_cell[0] == extent[0])
        & (node_cell[1] == extent[1])
        & (node_cell[2] == extent[2])
    ) | pad_skip  # the single far-corner node (+ last-slab node padding)

    choices = []
    for a in range(3):
        lo = jnp.clip(node_cell[a] - 1, 0, extent[a] - 1)
        hi = jnp.clip(node_cell[a] + 1, 0, extent[a] - 1)
        choices.append((lo, node_cell[a], hi))

    v_acc = jnp.zeros((L,), dtype)
    n_acc = [jnp.zeros((L,), dtype) for _ in range(3)]
    c_acc = [jnp.zeros((L,), dtype) for _ in range(4)]
    cnt = jnp.zeros((L,), jnp.int32)

    qgrid = quirk_grid or grid
    maxz = qgrid.maxz
    gx, gy, gz = grid.dims
    karange = jnp.arange(cap, dtype=jnp.int32)[:, None]
    for ck in (0, 1, 2):  # z choice
        for cj in (0, 1, 2):  # y
            for ci_ in (0, 1, 2):  # x (fastest — reference offsets order)
                sc = (choices[0][ci_], choices[1][cj], choices[2][ck])
                zc = morton_encode3(sc[0], sc[1], sc[2])
                # reference skip + end-rule (`src/sph.hpp:207-208`)
                ok = (~skip) & (zc < maxz) & (zc + 1 < maxz)
                if cell_offset is not None:
                    sc = tuple(
                        sc[a] + jnp.asarray(cell_offset[a], jnp.int32)
                        for a in range(3)
                    )
                    # gather cells outside the LOCAL grid contribute nothing.
                    # Clipping the flattened index instead would alias them
                    # onto the LAST local cell, multi-counting its particles
                    # for boundary corner nodes whenever a fast particle
                    # lands in the outer padding ring pre-solve (the cell
                    # table is built from pre-constraint pstar).
                    ok = (ok & (sc[0] >= 0) & (sc[0] < gx)
                          & (sc[1] >= 0) & (sc[1] < gy)
                          & (sc[2] >= 0) & (sc[2] < gz))
                lin = jnp.where(ok, (sc[0] * gy + sc[1]) * gz + sc[2], 0)
                lin = jnp.clip(lin, 0, gx * gy * gz - 1)
                start = jnp.where(ok, cell_table[lin], 0)
                end = jnp.where(ok, cell_table[lin + 1], 0)
                idx = start[None, :] + karange  # (K, L)
                mask = idx < end[None, :]
                idx = jnp.where(mask, idx, 0)

                lvec = [position[a][idx] - a_world[a][None, :] for a in range(3)]
                d2 = lvec[0] ** 2 + lvec[1] ** 2 + lvec[2] ** 2
                dist = jnp.sqrt(d2)
                # zero-distance particles are skipped (the reference divides by
                # zero and yields inf, `src/omp/ompsph.hpp:340-341`; a
                # measure-zero event we replace with the sane convention)
                use = mask & (ptype[idx] != OBSTACLE) & (dist < threshold)
                denom = dist**particle_influence
                use = use & (denom > 0)
                denom_safe = jnp.where(use, denom, 1.0)
                w = jnp.where(use, particle_size / denom_safe, 0.0)
                v_acc = v_acc + jnp.sum(w, axis=0)
                usef = use.astype(dtype)
                coef = (-particle_influence) * particle_size
                for a in range(3):
                    n_acc[a] = n_acc[a] + jnp.sum(
                        coef * (lvec[a] / denom_safe) * usef, axis=0
                    )
                for a in range(4):
                    c_acc[a] = c_acc[a] + jnp.sum(colour[a][idx] * usef, axis=0)
                cnt = cnt + jnp.sum(use, axis=0).astype(jnp.int32)

    n_norm = jnp.sqrt(n_acc[0] ** 2 + n_acc[1] ** 2 + n_acc[2] ** 2)
    lat_n = jnp.stack([n_acc[a] / n_norm for a in range(3)])  # NaN when empty (parity)
    cntf = cnt.astype(dtype)
    lat_c = jnp.stack([c_acc[a] / cntf for a in range(4)])  # NaN when cnt==0 (parity)
    return v_acc, lat_n, lat_c


def _corner_slices(lat, sample):
    """(..., L) lattice -> (8, ..., M) corner values via 3D shifted SLICES.

    The corner index sets are axis-shifted copies of the march grid, so
    slicing replaces the reference's per-corner indexed loads (`mc_size`
    corner gathers `src/ocl/oclsph_kernel.h:277-292`) with plain copies."""
    nx, ny, nz = sample
    mx, my, mz = nx - 1, ny - 1, nz - 1
    lead = lat.shape[:-1]
    lat3 = lat.reshape(lead + (nx, ny, nz))
    nlead = len(lead)
    outs = []
    for o in np.asarray(mct.CUBE_OFFSETS):
        lo = (0,) * nlead + (int(o[0]), int(o[1]), int(o[2]))
        hi = lead + (int(o[0]) + mx, int(o[1]) + my, int(o[2]) + mz)
        outs.append(jax.lax.slice(lat3, lo, hi).reshape(lead + (mx * my * mz,)))
    return jnp.stack(outs)


def _classify(vals, isolevel, cx, cy, cz, extent, spec: McSpec,
              node_offset=None, cube_x_hi=None, cube_y_hi=None):
    """Case classification: per-cube case index + triangle count (+ the
    multi-chip in-volume zeroing and local→global coordinate shift).

    `cube_x_hi` (traced scalar, multi-chip rebalance mode): global cube-x
    ownership bound — cubes at global x >= cube_x_hi belong to the right
    neighbour's dynamic slab and emit nothing here.  `cube_y_hi` is the
    same bound along y (2D tile decomposition, parallel/sharded2d.py)."""
    M = vals.shape[-1]
    ci = jnp.zeros((M,), jnp.int32)
    for i in range(8):
        ci = ci | ((vals[i] < isolevel).astype(jnp.int32) << i)
    edge_t = jnp.asarray(mct.EDGE_TABLE, jnp.int32)
    nvert_t = jnp.asarray(mct.NUM_VERTS_TABLE, jnp.int32)
    ntris = jnp.where(edge_t[ci] == 0, 0, nvert_t[ci] // 3)  # (M,)
    if node_offset is not None:
        gmarch = [int(np.floor(extent[a] * spec.resolution)) for a in range(3)]
        gcube = [
            c + jnp.asarray(node_offset[a], jnp.int32)
            for a, c in enumerate((cx, cy, cz))
        ]
        in_vol = (
            (gcube[0] < gmarch[0]) & (gcube[1] < gmarch[1]) & (gcube[2] < gmarch[2])
        )
        if cube_x_hi is not None:
            in_vol = in_vol & (gcube[0] < jnp.asarray(cube_x_hi, jnp.int32))
        if cube_y_hi is not None:
            in_vol = in_vol & (gcube[1] < jnp.asarray(cube_y_hi, jnp.int32))
        ntris = jnp.where(in_vol, ntris, 0)
        cx, cy, cz = gcube
    return ci, ntris, cx, cy, cz


def _edge_payload_iso(ci, vals, cnrm, ccol, cx, cy, cz, min_extent, step,
                      scale, dtype, isolevel):
    """Edge-lerped per-edge payload for K cubes.  Returns
    (tri15 (15,K) edge ids -1-padded, payload (10,12,K))."""
    offs8 = np.asarray(mct.CUBE_OFFSETS)
    # corner positions, component-major (8, K) per axis
    cpos = [
        (min_extent[a] + (jnp.stack([cx, cy, cz])[a][None, :]
                          + jnp.asarray(offs8[:, a], jnp.int32)[:, None]).astype(dtype) * step) * scale
        for a in range(3)
    ]
    e_from = np.asarray(mct.EDGE_CORNERS[:, 0])
    e_to = np.asarray(mct.EDGE_CORNERS[:, 1])
    v0 = vals[e_from]  # (12, K)
    v1 = vals[e_to]
    # raw divide: uncrossed edges produce NaN exactly like the reference's
    # unconditional lerp `scale()`; never selected by TRI_TABLE.
    t = ((isolevel - v0) / (v1 - v0)).astype(dtype)  # (12, K)

    def lerp(arr):  # (8,K) -> (12,K)
        a, b = arr[e_from], arr[e_to]
        return a + t * (b - a)

    payload = jnp.stack(
        [lerp(cpos[a]) for a in range(3)]
        + [lerp(cnrm[:, a]) for a in range(3)]
        + [lerp(ccol[:, a]) for a in range(4)]
    )
    tri_t = jnp.asarray(mct.TRI_TABLE, jnp.int32)  # (256,16)
    tri15 = tri_t[ci][:, :15].T                    # (15, K)
    return tri15, payload


def _emission_inputs(lat_v, lat_n, lat_c, min_extent, extent, spec: McSpec,
                     h: float, scale, isolevel, node_offset=None,
                     cube_x_hi=None, cube_y_hi=None):
    """Shared front half of extraction: case classification, triangle
    cumsum, edge-lerped per-edge payload.  Returns
    (ntris (M,), offs (M,) exclusive, total, tri15 (15,M), payload (10,12,M))."""
    dtype = lat_v.dtype
    nx, ny, nz = spec.sample
    mx, my, mz = nx - 1, ny - 1, nz - 1
    M = mx * my * mz
    step = jnp.asarray(h, dtype) / jnp.asarray(spec.resolution, dtype)

    idx = jnp.arange(M, dtype=jnp.int32)
    cx = idx // (my * mz)
    rem = idx - cx * (my * mz)
    cy = rem // mz
    cz = rem - cy * mz

    vals = _corner_slices(lat_v, spec.sample)       # (8, M)
    cnrm = _corner_slices(lat_n, spec.sample)       # (8, 3, M)
    ccol = _corner_slices(lat_c, spec.sample)       # (8, 4, M)

    ci, ntris, cx, cy, cz = _classify(
        vals, isolevel, cx, cy, cz, extent, spec, node_offset, cube_x_hi,
        cube_y_hi)
    offs = jnp.cumsum(ntris) - ntris  # exclusive
    total = offs[-1] + ntris[-1]

    tri15, payload = _edge_payload_iso(
        ci, vals, cnrm, ccol, cx, cy, cz, min_extent, step, scale, dtype,
        isolevel)
    return ntris, offs, total, tri15, payload


def mc_extract(lat_v, lat_n, lat_c, min_extent, extent, spec: McSpec,
               h: float, scale, isolevel, node_offset=None, cube_x_hi=None,
               cube_y_hi=None):
    """Case classification + cumsum compaction + deterministic emission
    (reference mc_size `src/ocl/oclsph_kernel.h:272-318` and mc_eval
    `:336-408`, atomics replaced by exclusive-cumsum offsets).

    Multi-chip slab mode: `node_offset` maps local cube/node coords to
    global ones for vertex world positions, and cubes whose global min
    corner falls outside the global march volume (last-slab padding) emit
    nothing.

    Structure: corner values come from shifted 3D slices (no gathers);
    per-vertex edge attributes are selected with an unrolled one-hot reduce
    over the 12 edges; emission sorts vertex slots by destination (invalid
    slots carry a past-the-end key), which packs the output exactly.
    Emission by SORT compaction instead of 15 column-scatters into
    (10, cap3).  Destination slots are unique and
    dense (0..3T-1 from the cumsum), so sorting by destination packs the
    output; the `big` tail is re-zeroed.  With `spec.emit_block` set the
    sort is two-stage (blocked compaction then a short merge sort — see the
    McSpec field comment); `emit_overflow` > 0 means a block held more live
    rows than `spec.emit_cap` and the mesh is INVALID — not merely short:
    the final pack-by-rank sort shifts every vertex after a dropped row
    while tri_count still reports the full total.  Consumers must either
    grow-and-re-run (models/growth.py — the advance()/bench paths) or treat
    any nonzero emit_overflow as a hard error (the sharded/timed paths
    surface it in their stats).

    Returns (vs (3, 3T), ns (3, 3T), cs (4, 3T), total, emit_overflow)."""
    dtype = lat_v.dtype
    if spec.cube_cap > 0:
        return _mc_extract_compacted(
            lat_v, lat_n, lat_c, min_extent, extent, spec, h, scale,
            isolevel, node_offset, cube_x_hi, cube_y_hi)
    ntris, offs, total, tri15, payload = _emission_inputs(
        lat_v, lat_n, lat_c, min_extent, extent, spec, h, scale, isolevel,
        node_offset, cube_x_hi, cube_y_hi)
    cap3 = spec.tri_capacity * 3
    keys, pays = _slot_rows(ntris, offs, tri15, payload, dtype)
    emit_ovf = jnp.asarray(0, jnp.int32)
    big = jnp.int32(1 << 30)
    M = ntris.shape[0]
    if spec.emit_block > 0:
        B = spec.emit_block
        smax = max(128, spec.emit_cap or EMIT_CAP_DEFAULT)
        nblk = -(-M // B)
        k15 = jnp.stack(keys)                        # (15, M)
        p15 = jnp.stack(pays, axis=1)                # (10, 15, M)
        padM = nblk * B - M
        if padM:
            k15 = jnp.pad(k15, ((0, 0), (0, padM)), constant_values=(1 << 30))
            p15 = jnp.pad(p15, ((0, 0), (0, 0), (0, padM)))
        # stage 1: per-block row sort compacts live rows to the front
        k2 = k15.reshape(15, nblk, B).transpose(1, 0, 2).reshape(nblk, 15 * B)
        p2 = p15.reshape(10, 15, nblk, B).transpose(0, 2, 1, 3).reshape(
            10, nblk, 15 * B)
        s1 = jax.lax.sort((k2,) + tuple(p2[a] for a in range(10)),
                          num_keys=1, is_stable=False)
        # overflow: live rows per block vs the static staging slice
        inc = offs + ntris  # inclusive triangle cumsum
        ends = jnp.minimum(jnp.arange(1, nblk + 1) * B, M) - 1
        live_b = 3 * (inc[ends] - offs[jnp.arange(nblk) * B])
        emit_ovf = jnp.maximum(jnp.max(live_b) - smax, 0).astype(jnp.int32)
        # stage 2: short merge sort over the staged rows
        scut = min(smax, 15 * B)
        flat = [o[:, :scut].reshape(-1) for o in s1]
        key, pay = flat[0], jnp.stack(flat[1:11])
    else:
        key = jnp.concatenate(keys)                  # (15M,)
        pay = jnp.concatenate(pays, axis=1)          # (10, 15M)
    nslot = key.shape[0]
    if nslot < cap3:  # tri capacity above the per-cube hard max: pad
        key = jnp.concatenate([key, jnp.full((cap3 - nslot,), big, jnp.int32)])
        pay = jnp.concatenate(
            [pay, jnp.zeros((10, cap3 - nslot), dtype)], axis=1
        )
    sorted_ops = jax.lax.sort(
        (key,) + tuple(pay[a] for a in range(10)), num_keys=1, is_stable=False
    )
    out = jnp.stack(sorted_ops[1:11])[:, :cap3]
    # tail beyond the live triangles is junk from overflow/invalid slots —
    # restore the zero-fill the scatter version guaranteed
    live = jnp.arange(cap3, dtype=jnp.int32) < total * 3
    out = jnp.where(live[None, :], out, 0.0)
    return out[0:3], out[3:6], out[6:10], total, emit_ovf


def _slot_rows(ntris, offs, tri15, payload, dtype):
    """Per-vertex-slot destination keys + payload rows for K cubes.

    Returns (keys: 15 x (K,) int32 — dest rank*3+corner for live slots,
    past-the-end BIG for dead ones; pays: 15 x (10, K))."""
    K = ntris.shape[0]
    big = jnp.int32(1 << 30)
    keys = []
    pays = []
    for k in range(3 * mct.MAX_TRIS_PER_CUBE):
        has = (k // 3) < ntris
        e = tri15[k]
        # one-hot select over the 12 edges (unrolled mul-add; no gather)
        sel = jnp.zeros((10, K), dtype)
        for j in range(12):
            sel = sel + jnp.where(e == j, payload[:, j], 0.0)
        keys.append(jnp.where(has, (offs + k // 3) * 3 + (k % 3), big))
        pays.append(sel)
    return keys, pays


def _mc_extract_compacted(lat_v, lat_n, lat_c, min_extent, extent,
                          spec: McSpec, h: float, scale, isolevel,
                          node_offset=None, cube_x_hi=None, cube_y_hi=None):
    """Cube-compaction emission (spec.cube_cap > 0; see the McSpec field).

    Stage 1 sorts the M cube indices by the unique key
    (live ? idx : BIG+idx) — ONE int32 operand, so the sort is cheap and
    compiles fast — and keeps the first cube_cap entries: the live cubes in
    ascending-idx (morton/global) order, so the restricted triangle cumsum
    equals the global one and the emitted mesh is bit-identical to the
    global path.  The 65 per-cube corner operands (8 values, 8x3 normals,
    8x4 colours) are then GATHERED from the lattice at just the K compacted
    cubes (~65*K elements vs sorting 66 operands of M rows, which we
    measured as a compile blowup), and the edge lerp + slot emission sort
    run on cube_cap cubes instead of M.  emit_overflow = live cubes beyond
    cube_cap (mesh INVALID — consumers grow and re-run)."""
    dtype = lat_v.dtype
    nx, ny, nz = spec.sample
    mx, my, mz = nx - 1, ny - 1, nz - 1
    M = mx * my * mz
    K = min(int(spec.cube_cap), M)
    cap3 = spec.tri_capacity * 3
    step = jnp.asarray(h, dtype) / jnp.asarray(spec.resolution, dtype)

    idx = jnp.arange(M, dtype=jnp.int32)
    cx = idx // (my * mz)
    rem = idx - cx * (my * mz)
    cy = rem // mz
    cz = rem - cy * mz

    vals = _corner_slices(lat_v, spec.sample)       # (8, M)

    # classification only for liveness (+ the multi-chip in-volume zeroing);
    # everything else is re-derived from the compacted idx
    ci, ntris, _, _, _ = _classify(
        vals, isolevel, cx, cy, cz, extent, spec, node_offset, cube_x_hi,
        cube_y_hi)
    live = ntris > 0
    nlive = jnp.sum(live).astype(jnp.int32)
    total = jnp.sum(ntris)

    big = jnp.int32(1 << 30)
    key = jnp.where(live, idx, big + idx)  # unique -> deterministic sort
    keyc = jax.lax.sort(key, is_stable=False)[:K]

    rank = jnp.arange(K, dtype=jnp.int32)
    live_c = rank < jnp.minimum(nlive, K)
    # local cube coords from the compacted idx (dead-tail rows carry a real
    # cube idx too — their junk payload feeds slots with past-the-end keys,
    # sliced off by the pack)
    idx_c = jnp.where(live_c, keyc, keyc - big)
    cxc = idx_c // (my * mz)
    remc = idx_c - cxc * (my * mz)
    cyc = remc // mz
    czc = remc - cyc * mz

    # gather the 8 corner node columns of the K cubes from the lattice
    nl = jnp.stack([
        (cxc + int(o[0])) * (ny * nz) + (cyc + int(o[1])) * nz
        + (czc + int(o[2]))
        for o in np.asarray(mct.CUBE_OFFSETS)
    ])                                                  # (8, K) node ids
    valsc = jnp.take(lat_v, nl, axis=-1)                # (8, K)
    cnrmc = jnp.take(lat_n, nl, axis=-1).transpose(1, 0, 2)  # (8, 3, K)
    ccolc = jnp.take(lat_c, nl, axis=-1).transpose(1, 0, 2)  # (8, 4, K)

    # case re-derived from the gathered values (bit-identical: same fp32
    # lattice entries, same comparison)
    cic = jnp.zeros((K,), jnp.int32)
    for i in range(8):
        cic = cic | ((valsc[i] < isolevel).astype(jnp.int32) << i)
    edge_t = jnp.asarray(mct.EDGE_TABLE, jnp.int32)
    nvert_t = jnp.asarray(mct.NUM_VERTS_TABLE, jnp.int32)
    # masked to the live prefix: an in-volume-zeroed cube (multi-chip) or a
    # dead-tail row must not re-emit even if its case is nonzero
    ntris_c = jnp.where(
        live_c & (edge_t[cic] != 0), nvert_t[cic] // 3, 0)
    # restricted cumsum == global exclusive cumsum at the live cubes
    # (dead cubes contribute 0 everywhere)
    offs_c = jnp.cumsum(ntris_c) - ntris_c

    if node_offset is not None:
        cxc = cxc + jnp.asarray(node_offset[0], jnp.int32)
        cyc = cyc + jnp.asarray(node_offset[1], jnp.int32)
        czc = czc + jnp.asarray(node_offset[2], jnp.int32)

    tri15c, payloadc = _edge_payload_iso(
        cic, valsc, cnrmc, ccolc, cxc, cyc, czc, min_extent, step, scale,
        dtype, isolevel)
    emit_ovf = jnp.maximum(nlive - K, 0).astype(jnp.int32)

    keys, pays = _slot_rows(ntris_c, offs_c, tri15c, payloadc, dtype)
    skey = jnp.concatenate(keys)                  # (15K,)
    spay = jnp.concatenate(pays, axis=1)          # (10, 15K)
    nslot = skey.shape[0]
    if nslot < cap3:
        skey = jnp.concatenate(
            [skey, jnp.full((cap3 - nslot,), big, jnp.int32)])
        spay = jnp.concatenate(
            [spay, jnp.zeros((10, cap3 - nslot), dtype)], axis=1)
    sorted_ops = jax.lax.sort(
        (skey,) + tuple(spay[a] for a in range(10)), num_keys=1,
        is_stable=False)
    out = jnp.stack(sorted_ops[1:11])[:, :cap3]
    livemask = jnp.arange(cap3, dtype=jnp.int32) < total * 3
    out = jnp.where(livemask[None, :], out, 0.0)
    return out[0:3], out[3:6], out[6:10], total, emit_ovf
