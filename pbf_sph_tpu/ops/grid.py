"""On-device spatial index: cell sort + dense CSR cell table.

Device-side replacement for the reference's host-side sort + grid-table build
(host std::sort `src/omp/ompsph.hpp:158`, makeGridTable `src/sph.hpp:238-250`):
everything stays on device inside the jitted step.

Design choice: particles are sorted by **row-major linear cell id**
(x*NY*NZ + y*NZ + z, z fastest), not by Morton code.  Linear order makes
every (dx,dy) slice of the 27-cell stencil one *contiguous* range of the
sorted particle array, so a neighbour sweep reads contiguous runs.  The
reference's Morton order only affects iteration
order (fp-summation order) and the writeback permutation, not membership.

Membership/skip semantics still mirror the reference exactly via Morton-code
checks (the reference skips stencil cells with `offset >= gridTableN`,
`src/sph.hpp:207`, and never gathers the last table cell, `src/sph.hpp:208`):
  * a particle is a grid member iff its cell is inside the extent box AND its
    Morton code is < maxz (excludes exactly the far-corner cell, like the
    reference)
  * a stencil target cell is gathered iff in-box and morton(cell)+1 < maxz
The one intentional divergence: cells *outside* the extent box whose Morton
code aliases into the table range (reachable in the reference only by
particles whose pStar overshoots the padded domain before the bounds clamp)
are treated as invalid here; see SURVEY.md §7 fidelity notes.

The dense table is built with scatter-add + cumsum (O(n + ncells) dense ops)
instead of searchsorted (a binary search of 20+ dependent gather rounds).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import jax.numpy as jnp

from pbf_sph_tpu.ops.curves import morton_encode3

# 27-cell stencil, x fastest (reference `src/sph.hpp:220-234` order).
STENCIL27 = [(dx, dy, dz) for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]

# The 9 (dx,dy) strips of the stencil; each strip covers dz in {-1,0,1} as one
# contiguous linear-id range.
STRIPS9 = [(dx, dy) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]

Cells = Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]  # three (C,) int32


@dataclass(frozen=True)
class GridSpec:
    """Static grid geometry, fixed at trace time.

    The reference recomputes the extent from the (per-frame moving) bounds in
    fp32 every frame (`src/omp/ompsph.hpp:133-135`); under translation-only
    motion the span is constant up to 1 ulp, so we freeze the extent computed
    from the *initial* bounds and keep minExtent dynamic.
    """

    extent: Tuple[int, int, int]
    maxz: int
    # True: replicate the reference's Morton-table boundary quirks exactly
    # (single-chip parity mode).  False: clean semantics — every in-box cell
    # is a valid member/target (used by the multichip domain decomposition,
    # where a local slab's "far corner" is an interior cell of the global
    # domain and must not be dropped).
    quirks: bool = True

    @property
    def dims(self) -> Tuple[int, int, int]:
        """Linear grid dims: cells have coords in [0, extent] inclusive."""
        return (self.extent[0] + 1, self.extent[1] + 1, self.extent[2] + 1)

    @property
    def ncells(self) -> int:
        nx, ny, nz = self.dims
        return nx * ny * nz

    @staticmethod
    def from_bounds(min_bound, max_bound, scale: float, h: float) -> "GridSpec":
        f = np.float32
        padding = f(h) * f(2)
        min_extent = np.asarray(min_bound, f) / f(scale) - padding
        max_extent = np.asarray(max_bound, f) / f(scale) + padding
        extent = np.trunc((max_extent - min_extent) / f(h)).astype(np.int64)
        maxz = int(morton_encode3(int(extent[0]), int(extent[1]), int(extent[2])))
        return GridSpec(extent=tuple(int(v) for v in extent), maxz=maxz)


def cell_coords(pstar: Tuple, min_extent, h: float) -> Cells:
    """Per-axis (C,) int32 cell coords by C-style truncation
    (reference `src/sph.hpp:198-201`); may be negative / out of range."""
    out = []
    for axis in range(3):
        c = (pstar[axis] - min_extent[axis]) / jnp.asarray(h, pstar[axis].dtype)
        c = jnp.clip(c, -2.0e9, 2.0e9)
        c = jnp.where(jnp.isnan(c), 2.0e9, c)
        out.append(jnp.trunc(c).astype(jnp.int32))
    return tuple(out)


def sort_key(cells: Cells, alive, spec: GridSpec):
    """Linear-cell-id sort key with invalid/dead slots pushed to the end.

    Key layout: [0, ncells) valid cell ids; ncells = invalid-but-alive;
    ncells+1 = dead.  Membership mirrors the reference's Morton rules (see
    module docstring)."""
    nx, ny, nz = spec.dims
    in_box = None
    for a, n in zip(cells, (nx, ny, nz)):
        m = (a >= 0) & (a < n)
        in_box = m if in_box is None else (in_box & m)
    safe = [jnp.where(in_box, c, 0) for c in cells]
    if spec.quirks:
        z = morton_encode3(safe[0], safe[1], safe[2])
        member = in_box & (z < spec.maxz)
    else:
        member = in_box
    lin = (safe[0] * ny + safe[1]) * nz + safe[2]
    key = jnp.where(alive & member, lin, jnp.int32(spec.ncells))
    key = jnp.where(alive, key, jnp.int32(spec.ncells + 1))
    return key


def decode_key(key, spec: GridSpec) -> Tuple[Cells, jnp.ndarray]:
    """Recover cell coords from a sorted key; returns (cells, member_mask)."""
    nx, ny, nz = spec.dims
    member = key < spec.ncells
    k = jnp.where(member, key, 0)
    cx = k // (ny * nz)
    rem = k - cx * (ny * nz)
    cy = rem // nz
    cz = rem - cy * nz
    return (cx, cy, cz), member


def build_cell_table(sorted_key, spec: GridSpec):
    """Dense CSR cell-start table: table[c] = first sorted index with key >= c
    (same semantics as the reference's `makeGridTable`, `src/sph.hpp:238-250`,
    over linear ids).  table has ncells+1 entries; table[ncells] = member count.

    Built with scatter-add + exclusive cumsum — dense ops only."""
    ncells = spec.ncells
    k = jnp.minimum(sorted_key, ncells)  # invalid+dead pile into the sentinel
    cnt = jnp.zeros((ncells + 1,), jnp.int32).at[k].add(1, mode="drop")
    return (jnp.cumsum(cnt) - cnt).astype(jnp.int32)


def stencil_ranges(cells: Cells, member, cell_table, spec: GridSpec) -> List[Tuple]:
    """Per-particle [start, end) candidate ranges for each of the 27 stencil
    cells (reference `foreach_grid`, `src/sph.hpp:203-236`).  `cells`/`member`
    must be in sorted order.  Returns a 27-element list of (start, end)."""
    nx, ny, nz = spec.dims
    maxz = spec.maxz
    out = []
    for dx, dy, dz in STENCIL27:
        nc = (cells[0] + dx, cells[1] + dy, cells[2] + dz)
        in_box = (
            (nc[0] >= 0) & (nc[0] < nx)
            & (nc[1] >= 0) & (nc[1] < ny)
            & (nc[2] >= 0) & (nc[2] < nz)
        )
        safe = [jnp.where(in_box, c, 0) for c in nc]
        if spec.quirks:
            zc = morton_encode3(safe[0], safe[1], safe[2])
            # reference skip rule + end-rule quirk (src/sph.hpp:207-208)
            ok = member & in_box & (zc < maxz) & (zc + 1 < maxz)
        else:
            ok = member & in_box
        lin = (safe[0] * ny + safe[1]) * nz + safe[2]
        lin = jnp.where(ok, lin, 0)
        start = jnp.where(ok, cell_table[lin], 0)
        end = jnp.where(ok, cell_table[lin + 1], 0)
        out.append((start, end))
    return out


def max_cell_occupancy(cell_table):
    """Largest cell population — the neighbour-gather capacity check."""
    return jnp.max(cell_table[1:] - cell_table[:-1])
