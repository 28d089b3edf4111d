"""Behavioral tests of the NumPy oracle backend."""

import numpy as np
import pytest

from pbf_sph_tpu.core.scene import apply_motion_sin_x_cos_z, simple_config_with_2_cubes
from pbf_sph_tpu.core.types import Drain, Query, Scene, Source, Well, FLUID
from pbf_sph_tpu.models.numpy_solver import NumpySolver, _ragged_ranges, BIG
from pbf_sph_tpu.ops.curves import morton_encode3


def small_setup(count=2000, iters=3):
    mc, cfg, particles = simple_config_with_2_cubes(count, iters, 500.0)
    return mc, cfg, particles


def test_ragged_ranges():
    start = np.array([3, 10, 0])
    count = np.array([2, 0, 3])
    rows, vals = _ragged_ranges(start, count)
    np.testing.assert_array_equal(rows, [0, 0, 2, 2, 2])
    np.testing.assert_array_equal(vals, [3, 4, 0, 1, 2])


def test_grid_table_matches_reference_loop():
    """searchsorted construction == the reference's makeGridTable loop
    (reference `src/sph.hpp:238-250`)."""
    rng = np.random.default_rng(0)
    maxz = int(morton_encode3(6, 6, 6))
    keys = np.sort(rng.integers(0, maxz + 40, 300))  # includes out-of-table keys

    # literal re-expression of the reference loop
    table_ref = np.zeros(maxz, np.int64)
    gi = 0
    for z in range(maxz):
        table_ref[z] = gi
        while gi != len(keys) and keys[gi] == z:
            gi += 1

    table = np.searchsorted(keys, np.arange(maxz + 1), side="left")
    np.testing.assert_array_equal(table[:maxz], table_ref)


def test_stencil_pairs_vs_bruteforce():
    """Pair enumeration must equal the brute-force definition: b is a neighbour
    of a iff b's cell is one of the 27 cells around a's cell, the cell code is
    inside the table, and (quirk) the cell is not the last table entry
    (reference end-rule `src/sph.hpp:208`)."""
    rng = np.random.default_rng(1)
    solver = NumpySolver()
    n = 120
    extent = np.array([5, 5, 5], np.int64)
    maxz = int(morton_encode3(5, 5, 5))
    cells = rng.integers(0, 6, (n, 3)).astype(np.int64)  # some out-of-box (== extent)
    codes = solver._codes_of(cells)
    key = np.where(codes < maxz, codes, BIG)
    order = np.argsort(key, kind="stable")
    cells, codes, key = cells[order], codes[order], key[order]
    grid_table = np.searchsorted(key, np.arange(maxz + 1), side="left")

    A, B = solver._stencil_pairs(cells, codes, grid_table, maxz)
    got = set(zip(A.tolist(), B.tolist()))

    expected = set()
    for a in range(n):
        if codes[a] >= maxz:
            continue  # invalid centers gather nothing
        for b in range(n):
            if codes[b] >= maxz:
                continue  # out-of-table particles are never members
            if codes[b] + 1 >= maxz:
                continue  # end-rule quirk: the last table cell is never gathered
            if (np.abs(cells[b] - cells[a]) <= 1).all():
                expected.add((a, b))
    assert got == expected


def test_two_cube_frames_invariants():
    mc, cfg, particles = small_setup()
    solver = NumpySolver()
    xs = particles
    n0 = len(xs)
    for frame in range(3):
        res, xs = solver.advance(apply_motion_sin_x_cos_z(cfg, frame), Scene(), xs)
    assert len(xs) == n0
    # ids preserved as a set (order permutes by design)
    np.testing.assert_array_equal(np.sort(xs.pid), np.sort(particles.pid))
    # positions clamped into the (moved) bounds
    moved = apply_motion_sin_x_cos_z(cfg, 2)
    assert (xs.position >= np.asarray(moved.min_bound) - 1e-3).all()
    assert (xs.position <= np.asarray(moved.max_bound) + 1e-3).all()
    assert np.isfinite(xs.velocity).all()
    # colours stay clamped
    assert (xs.colour >= 0.029).all() and (xs.colour <= 1.0001).all()


def test_gravity_pulls_down():
    mc, cfg, particles = small_setup()
    solver = NumpySolver()
    y0 = particles.position[:, 1].mean()
    res, xs = solver.advance(cfg, Scene(), particles)
    assert xs.position[:, 1].mean() > y0  # +y gravity in this model


def test_density_approaches_rest():
    """After several constraint iterations the fluid must compress toward the
    rest density (the physics sanity anchor)."""
    mc, cfg, particles = small_setup(count=4000, iters=6)
    solver = NumpySolver()
    xs = particles
    for frame in range(8):
        _, xs = solver.advance(apply_motion_sin_x_cos_z(cfg, frame), Scene(), xs)
    # spacing shrank from the initial lattice (22 world units): mean nearest-
    # neighbour distance should compress substantially.
    from scipy.spatial import cKDTree

    t = cKDTree(xs.position)
    d, _ = t.query(xs.position, k=2)
    assert d[:, 1].mean() < 19.5  # initial lattice spacing is 22


def test_marching_cubes_smoke():
    mc, cfg, particles = small_setup(count=2000)
    cfg = cfg.replace(surface=mc)
    solver = NumpySolver()
    res, xs = solver.advance(cfg, Scene(), particles)
    assert len(res.mesh.vs) > 0
    assert len(res.mesh.vs) % 3 == 0
    assert res.mesh.ns.shape == res.mesh.vs.shape
    assert res.mesh.cs.shape[0] == res.mesh.vs.shape[0]
    assert np.isfinite(res.mesh.vs).all()


def test_surface_of_matches_frame_mesh():
    """surface_of(input, output) re-extracts exactly the frame's own mesh
    from the frame's output particles, whatever order they come in."""
    mc, cfg, particles = small_setup(count=2000)
    cfg = cfg.replace(surface=mc)
    solver = NumpySolver()
    res, xs = solver.advance(cfg, Scene(), particles)
    shuffled = xs.order_by_id()
    mesh = solver.surface_of(cfg, particles, shuffled)
    np.testing.assert_array_equal(mesh.vs, res.mesh.vs)
    np.testing.assert_array_equal(mesh.cs, res.mesh.cs)
    short = type(xs)(xs.pid[1:], xs.ptype[1:], xs.mass[1:],
                     xs.position[1:], xs.velocity[1:], xs.colour[1:])
    with pytest.raises(ValueError):
        solver.surface_of(cfg, particles, short)


def test_source_drain_query():
    mc, cfg, particles = small_setup(count=1000)
    scene = Scene(
        sources=[Source(tag=999, centre=(500, 500, 500), velocity=(0, 0, 0), colour=(1, 0, 0, 1), rate=16)],
        drains=[Drain(tag=0, centre=(100, 100, 100), width=120.0)],
        queries=[Query(id=7, point=(500, 500, 500))],
    )
    solver = NumpySolver()
    n0 = len(particles)
    res, xs = solver.advance(cfg, scene, particles)
    spawned = (xs.pid == 999).sum()
    assert spawned == 16  # floor(sqrt(16)) * ceil(sqrt(16))
    assert len(xs) < n0 + 16  # drain removed some initial-cube particles
    assert len(res.queries) == 1 and res.queries[0].id == 7


def test_well_attracts():
    mc, cfg, particles = small_setup(count=1000)
    cfg = cfg.replace(constant_force=(0.0, 0.0, 0.0))
    centre = np.array([150.0, 30.0, 150.0])  # inside cube 1 (well radius is 75)
    scene = Scene(wells=[Well(tag=0, centre=tuple(centre), force=200.0)])
    solver = NumpySolver()
    xs_w = xs_n = particles
    for _ in range(5):
        _, xs_w = solver.advance(cfg, scene, xs_w)
        _, xs_n = solver.advance(cfg, Scene(), xs_n)
    d_w = np.linalg.norm(xs_w.order_by_id().position - centre, axis=1).mean()
    d_n = np.linalg.norm(xs_n.order_by_id().position - centre, axis=1).mean()
    assert d_w < d_n


def test_depleted():
    mc, cfg, particles = small_setup(count=1000)
    scene = Scene(drains=[Drain(tag=0, centre=(500, 500, 500), width=1e9)])
    solver = NumpySolver()
    res, xs = solver.advance(cfg, scene, particles)
    assert len(xs) == 0
    assert len(res.mesh.vs) == 0
