"""PBF phase ops — XLA path.

Each phase mirrors one reference kernel over the 27-cell Morton stencil
(reference kernels: diffuse `src/ocl/oclsph_kernel.h:67-93`, lambda `:95-123`,
delta `:125-162`, finalise `:164-174`; host phases: sources/drains/advect
`src/omp/ompsph.hpp:93-155`).

Design: neighbour iteration is a statically unrolled loop over the 27
stencil offsets; each offset contributes a dense (K, C) gather of cell
candidates (K = static per-cell capacity, C = particle capacity) that XLA
fuses into the pairwise math and a masked reduction over K.  All vector
quantities are component tuples of (C,)/(K,C) arrays, never (..., 3)-trailing
shapes.  No atomics, no host round-trips, static shapes.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import jax.numpy as jnp

from pbf_sph_tpu.core.constants import DEFAULT_CONSTANTS as K
from pbf_sph_tpu.core.types import FLUID, OBSTACLE
from pbf_sph_tpu.ops.kernels import poly6_factor, spiky_kernel_factor

V3 = Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]


def _candidates(start, end, cap: int):
    """(K, C) candidate indices + mask from per-particle [start, end)."""
    idx = start[None, :] + jnp.arange(cap, dtype=jnp.int32)[:, None]
    mask = idx < end[None, :]
    return jnp.where(mask, idx, 0), mask


def _poly6_block(r2, mask, h: float, factor):
    hh = h * h
    v = factor * (hh - r2) ** 3
    return jnp.where(mask & (r2 <= hh), v, 0.0)


def _spiky_scale_block(r, mask, h: float, factor, eps: float):
    """Scalar multiplier s such that spiky_grad = d * s (d = x - y)."""
    valid = mask & (r >= eps) & (r <= h)
    r_safe = jnp.where(valid, r, 1.0)
    s = factor * ((h - r_safe) ** 2 / r_safe)
    return jnp.where(valid, s, 0.0)


# ---------------------------------------------------------------------------
# Advection + external forces
# ---------------------------------------------------------------------------


def advect(position, velocity, mass, ptype, alive, wells_centre, wells_force,
           constant_force, dt, scale):
    """v += F*dt; pStar = v*dt + pos/scale for fluid particles
    (reference `src/omp/ompsph.hpp:137-151`); obstacles keep pStar = pos/scale
    (OCL semantics, `src/ocl/oclsph.cpp:64-69`).

    `position`/`velocity` are (3, C); returns ((3,C) vel, (3,C) pstar)."""
    fluid = (ptype == FLUID) & alive
    force = [mass * constant_force[a] for a in range(3)]
    n_wells = wells_centre.shape[0]
    for w in range(n_wells):  # static, tiny
        diff = [wells_centre[w, a] - position[a] for a in range(3)]
        dist = jnp.sqrt(diff[0] ** 2 + diff[1] ** 2 + diff[2] ** 2)
        near = dist < 75.0
        dist_safe = jnp.where(dist > 0, dist, 1.0)
        for a in range(3):
            fw = (diff[a] / dist_safe) * wells_force[w] * mass / (dist_safe * dist_safe)
            fw = jnp.clip(fw, -10.0, 10.0)
            force[a] = force[a] + jnp.where(near, fw, 0.0)
    vel = jnp.stack(
        [jnp.where(fluid, velocity[a] + force[a] * dt, velocity[a]) for a in range(3)]
    )
    pstar = jnp.stack(
        [
            jnp.where(fluid, vel[a] * dt + position[a] / scale, position[a] / scale)
            for a in range(3)
        ]
    )
    return vel, pstar


# ---------------------------------------------------------------------------
# Neighbour phases
# ---------------------------------------------------------------------------


def diffuse(colour, ptype, alive, ranges: List[Tuple], cap: int, dt):
    """Colour diffusion (reference `src/omp/ompsph.hpp:188-207`): neighbour
    colour mean * 1.33 mixed in with weight dt/750, clamped to [0.03, 1].
    `colour` is (4, C)."""
    dtype = colour.dtype
    n = colour.shape[1]
    mixture = [jnp.zeros((n,), dtype) for _ in range(4)]
    cnt = jnp.zeros((n,), jnp.int32)
    for start, end in ranges:
        idx, mask = _candidates(start, end, cap)
        nb_ok = mask & (ptype[idx] != OBSTACLE)
        w = nb_ok.astype(dtype)
        for a in range(4):
            mixture[a] = mixture[a] + jnp.sum(colour[a][idx] * w, axis=0)
        cnt = cnt + jnp.sum(nb_ok, axis=0).astype(jnp.int32)
    cnt_safe = jnp.maximum(cnt, 1).astype(dtype)
    upd = (ptype == FLUID) & alive & (cnt > 0)
    rows = []
    for a in range(4):
        target = (mixture[a] / cnt_safe) * jnp.asarray(1.33, dtype)
        mixed = colour[a] + (dt / jnp.asarray(750.0, dtype)) * (target - colour[a])
        mixed = jnp.clip(mixed, 0.03, 1.0)
        rows.append(jnp.where(upd, mixed, colour[a]))
    return jnp.stack(rows)


def _pair_block(pstar, idx):
    """Candidate displacement components + squared distance for one offset.
    `pstar` is (3, C); idx is (K, C).  Returns ((dx,dy,dz) each (K,C), r2)."""
    d = [pstar[a][None, :] - pstar[a][idx] for a in range(3)]
    r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    return d, r2


def lambda_phase(pstar, mass, ptype, alive, ranges, cap: int, h: float):
    """Density-constraint multiplier (reference `src/ocl/oclsph_kernel.h:95-123`):
    rho_i = m_i * sum_j poly6(r); lambda = -(rho/RHO - 1)/(|grad C|^2 + CFM)."""
    dtype = pstar.dtype
    n = pstar.shape[1]
    p6f = jnp.asarray(poly6_factor(h), dtype)
    skf = jnp.asarray(spiky_kernel_factor(h), dtype)
    p6_sum = jnp.zeros((n,), dtype)
    grad = [jnp.zeros((n,), dtype) for _ in range(3)]
    for start, end in ranges:
        idx, mask = _candidates(start, end, cap)
        d, r2 = _pair_block(pstar, idx)
        r = jnp.sqrt(r2)
        p6_sum = p6_sum + jnp.sum(_poly6_block(r2, mask, h, p6f), axis=0)
        s = _spiky_scale_block(r, mask, h, skf, K.EPSILON)
        for a in range(3):
            grad[a] = grad[a] + jnp.sum(d[a] * s, axis=0)
    rho = mass * p6_sum
    rr = jnp.asarray(K.RHO_RECIP, dtype)
    norm2 = (grad[0] * rr) ** 2 + (grad[1] * rr) ** 2 + (grad[2] * rr) ** 2
    ci = rho * rr - 1.0
    lam = -ci / (norm2 + jnp.asarray(K.CFM_EPSILON, dtype))
    return jnp.where((ptype == FLUID) & alive, lam, 0.0)


def delta_phase(pstar, lam, ptype, alive, ranges, cap: int, h: float,
                scale, min_bound, max_bound):
    """Position correction + in-iteration bounds clamp
    (reference `src/ocl/oclsph_kernel.h:125-162`).  `pstar` is (3, C)."""
    dtype = pstar.dtype
    n = pstar.shape[1]
    p6f = jnp.asarray(poly6_factor(h), dtype)
    skf = jnp.asarray(spiky_kernel_factor(h), dtype)
    cdq = jnp.asarray(K.CORR_DELTA_Q * h, dtype)
    p6dq = p6f * (jnp.asarray(h * h, dtype) - cdq * cdq) ** 3
    rr = jnp.asarray(K.RHO_RECIP, dtype)
    dp = [jnp.zeros((n,), dtype) for _ in range(3)]
    for start, end in ranges:
        idx, mask = _candidates(start, end, cap)
        d, r2 = _pair_block(pstar, idx)
        r = jnp.sqrt(r2)
        p6 = _poly6_block(r2, mask, h, p6f)
        x = p6 / p6dq
        x2 = x * x
        corr = jnp.asarray(-K.CORR_K, dtype) * x2 * x2  # x^CORR_N, CORR_N = 4
        factor = (lam[None, :] + lam[idx] + corr) * rr
        s = _spiky_scale_block(r, mask, h, skf, K.EPSILON) * factor
        for a in range(3):
            dp[a] = dp[a] + jnp.sum(d[a] * s, axis=0)
    fluid = (ptype == FLUID) & alive
    rows = []
    for a in range(3):
        moved = jnp.clip((pstar[a] + dp[a]) * scale, min_bound[a], max_bound[a]) / scale
        rows.append(jnp.where(fluid, moved, pstar[a]))
    return jnp.stack(rows)


def finalise(position, velocity, pstar, ptype, alive, dt, scale, dtype):
    """v = (dX/dt + v)*VD; pos = pStar*scale
    (reference `src/ocl/oclsph_kernel.h:164-174`).  All (3, C)."""
    fluid = (ptype == FLUID) & alive
    vd = jnp.asarray(K.VD, dtype)
    inv_dt = jnp.asarray(1.0, dtype) / dt
    pos_rows, vel_rows = [], []
    for a in range(3):
        delta_x = pstar[a] - position[a] / scale
        pos_rows.append(jnp.where(fluid, pstar[a] * scale, position[a]))
        vel_rows.append(
            jnp.where(fluid, (delta_x * inv_dt + velocity[a]) * vd, velocity[a])
        )
    return jnp.stack(pos_rows), jnp.stack(vel_rows)
