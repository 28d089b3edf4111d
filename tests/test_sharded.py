"""Multi-chip domain decomposition vs single-chip parity (virtual CPU mesh)."""

import numpy as np
import pytest
import jax
from jax.sharding import Mesh

from pbf_sph_tpu.core.configs import dam_break
from pbf_sph_tpu.core.scene import simple_config_with_2_cubes
from pbf_sph_tpu.core.types import Drain, Query, Scene, Source, Well
from pbf_sph_tpu.models.jax_solver import (
    JaxSolver,
    dyn_params_of,
    scene_arrays_of,
)
from pbf_sph_tpu.parallel import sharded


def run_sharded(cfg, particles, n_dev, frames, scene=None):
    mesh = Mesh(np.array(jax.devices()[:n_dev]), (sharded.AXIS,))
    spec = sharded.ShardSpec.create(
        cfg, n_dev, len(particles), cfg.h, scene=scene
    )
    state = sharded.distribute_particles(particles, spec)
    state = sharded.shard_state(state, mesh)
    step = sharded.build_sharded_step(spec, mesh)
    dyn = dyn_params_of(cfg, np.float32)
    scn = (
        scene_arrays_of(scene, spec.scene, np.float32)
        if scene is not None else None
    )
    stats = None
    with mesh:
        for _ in range(frames):
            state, stats = step(state, dyn, scn)
    return state.to_soa(), {k: np.asarray(v) for k, v in stats.items()}


def run_single(cfg, particles, frames):
    js = JaxSolver(h=cfg.h)
    xs = particles
    for _ in range(frames):
        _, xs = js.advance(cfg, Scene(), xs)
    return xs


def test_equal_count_target_no_int32_overflow():
    # The rebalancers' equal-count targets are computed on traced int32
    # counts (jnp int64 silently truncates to int32 unless jax_enable_x64 is
    # on, so widening is not available).  The decomposed form must match
    # exact integer arithmetic right up to the int32 ceiling, where the
    # naive total*d product wraps (e.g. 2e9 * 127 >> 2^31).
    import jax.numpy as jnp

    f = jax.jit(sharded._equal_count_target, static_argnums=(1, 2))
    for total in (0, 1, 97, 1_000_003, 2_000_000_000, 2_147_483_647):
        for n in (2, 8, 128):
            for d in (1, n // 2, n - 1):
                got = int(f(jnp.asarray(total, jnp.int32), d, n))
                assert got == (total * d) // n, (total, d, n, got)


@pytest.mark.parametrize("n_dev", [2, 4])
@pytest.mark.slow
def test_sharded_matches_single(n_dev):
    mc, cfg, particles = dam_break(1200, solver_iter=3)
    xs_m, stats = run_sharded(cfg, particles, n_dev, frames=2)
    xs_s = run_single(cfg, particles, frames=2)
    assert stats["migrate_dropped"].sum() == 0
    assert stats["ghost_dropped"].sum() == 0
    assert len(xs_m) == len(xs_s)
    a = xs_m.order_by_id()
    b = xs_s.order_by_id()
    np.testing.assert_array_equal(a.pid, b.pid)
    np.testing.assert_allclose(a.position, b.position, atol=0.1, rtol=0)
    np.testing.assert_allclose(a.velocity, b.velocity, atol=0.1, rtol=0)
    np.testing.assert_allclose(a.colour, b.colour, atol=2e-3, rtol=0)


@pytest.mark.slow
def test_sharded_scene_dynamics_matches_single():
    """Wells, sources, drains, and queries in the multi-chip step match the
    single-chip run (reference pipeline `src/ocl/oclsph.cpp:322-350,392-409`
    runs every frame; round 1 dropped all of these in distributed mode)."""
    mc, cfg, particles = dam_break(1200, solver_iter=3)
    lo = np.asarray(cfg.min_bound, np.float32)
    hi = np.asarray(cfg.max_bound, np.float32)
    mid = (lo + hi) / 2
    scene = Scene(
        wells=[Well(tag=0, centre=tuple(mid * 0.6), force=150.0)],
        sources=[Source(tag=777, centre=tuple(mid), velocity=(0, 1, 0),
                        colour=(1, 0, 0, 1), rate=9)],
        drains=[Drain(tag=0, centre=tuple(mid * 0.3), width=40.0)],
        queries=[Query(id=3, point=tuple(mid * 0.5))],
    )
    xs_m, stats = run_sharded(cfg, particles, 4, frames=2, scene=scene)

    js = JaxSolver(h=cfg.h)
    xs_s = particles
    res = None
    for _ in range(2):
        res, xs_s = js.advance(cfg, scene, xs_s)

    assert stats["migrate_dropped"].sum() == 0
    assert stats["spawn_dropped"].sum() == 0
    assert len(xs_m) == len(xs_s)

    # spawned particles share a tag id; canonicalize by (id, rounded pos)
    def canon(xs):
        r = np.round(xs.position, 1)
        o = np.lexsort((r[:, 2], r[:, 1], r[:, 0], xs.pid))
        from pbf_sph_tpu.core.types import ParticleSoA

        return ParticleSoA(xs.pid[o], xs.ptype[o], xs.mass[o],
                           xs.position[o], xs.velocity[o], xs.colour[o])

    a, b = canon(xs_m), canon(xs_s)
    np.testing.assert_array_equal(a.pid, b.pid)
    np.testing.assert_allclose(a.position, b.position, atol=0.1, rtol=0)
    np.testing.assert_allclose(a.colour, b.colour, atol=2e-3, rtol=0)

    got = set(int(v) for v in stats["query_ids"][0] if v >= 0)
    want = set(res.queries[0].neighbours.tolist())
    assert got == want
    assert int(stats["query_counts"][0]) == len(want)


@pytest.mark.slow
@pytest.mark.nightly
@pytest.mark.parametrize("compacted", [False, True])
def test_sharded_mc_matches_single(compacted):
    """Slab-local marching cubes (field over local nodes + ghost-column
    gathers, cube emission partitioned by slab) produces the same triangle
    set as the single-chip run.  `compacted=True` forces the cube-compaction
    emission (McSpec.cube_cap — auto-enabled only at large march volumes) on
    BOTH sides to certify it multichip, where the in-volume/ownership
    masking must survive the compaction."""
    import dataclasses

    mc, cfg, particles = simple_config_with_2_cubes(1500, 2, 500.0)
    # resolution 1.0 (vs the GUI default 2.0) cuts the lattice 8x: the
    # parity logic is resolution-independent and the CPU compile dominates
    # this test's wall time
    cfg = cfg.replace(surface=dataclasses.replace(mc, resolution=1.0))

    js = JaxSolver(h=cfg.h)
    res, _ = js.advance(cfg, Scene(), particles)
    T_ref = res.mesh.vs.shape[0] // 3
    assert T_ref > 0  # the scene must actually produce a surface

    n_dev = 2
    mesh = Mesh(np.array(jax.devices()[:n_dev]), (sharded.AXIS,))
    spec = sharded.ShardSpec.create(cfg, n_dev, len(particles), cfg.h)
    assert spec.surface is not None
    if compacted:
        # force the cap well above this scene's live cubes; the single-chip
        # reference stays on the global path — compaction must be
        # bit-identical to it
        lvol = int(np.prod([s - 1 for s in spec.surface.sample]))
        spec = dataclasses.replace(
            spec, surface=dataclasses.replace(
                spec.surface, cube_cap=-(-lvol // 4 // 128) * 128))
    state = sharded.distribute_particles(particles, spec)
    state = sharded.shard_state(state, mesh)
    step = sharded.build_sharded_step(spec, mesh)
    dyn = dyn_params_of(cfg, np.float32)
    with mesh:
        state, stats = step(state, dyn)

    assert int(np.asarray(stats["mc_emit_overflow"]).sum()) == 0
    counts = np.asarray(stats["tri_count"]).ravel()
    assert counts.sum() == T_ref
    cap3 = spec.surface.tri_capacity * 3
    vs = np.asarray(stats["mesh_vs"])          # (3, n_dev*cap3)

    def tri_rows(v3, tcounts, cap3_each):
        rows = []
        for d, tc in enumerate(tcounts):
            seg = v3[:, d * cap3_each : d * cap3_each + 3 * int(tc)]
            rows.append(seg.T.reshape(int(tc), 9))
        return np.concatenate(rows) if rows else np.zeros((0, 9))

    got = tri_rows(vs, counts, cap3)
    want = res.mesh.vs.reshape(T_ref, 9)

    def canon(a):
        r = np.round(a, 3)
        return r[np.lexsort(r.T[::-1])]

    np.testing.assert_allclose(canon(got), canon(want), atol=2e-2, rtol=0)


@pytest.mark.slow
def test_sharded_conserves_particles_under_motion():
    from pbf_sph_tpu.core.scene import apply_motion_sin_x_cos_z

    mc, cfg, particles = dam_break(1500, solver_iter=2)
    mesh = Mesh(np.array(jax.devices()[:4]), (sharded.AXIS,))
    spec = sharded.ShardSpec.create(cfg, 4, len(particles), cfg.h)
    state = sharded.distribute_particles(particles, spec)
    state = sharded.shard_state(state, mesh)
    step = sharded.build_sharded_step(spec, mesh)
    with mesh:
        for f in range(4):
            c = apply_motion_sin_x_cos_z(cfg, f)
            state, stats = step(state, dyn_params_of(c, np.float32))
    assert int(np.asarray(stats["alive_count"]).sum()) == len(particles)
    out = state.to_soa()
    np.testing.assert_array_equal(np.sort(out.pid), np.sort(particles.pid))


def run_sharded_rebalance(cfg, particles, n_dev, frames, motion=False,
                          cap_local=0, ghost_cap=0, min_slab_w=3, settle=0):
    from pbf_sph_tpu.core.scene import apply_motion_sin_x_cos_z

    mesh = Mesh(np.array(jax.devices()[:n_dev]), (sharded.AXIS,))
    spec = sharded.ShardSpec.create(
        cfg, n_dev, len(particles), cfg.h, rebalance=True, cap_local=cap_local,
        ghost_cap=ghost_cap, min_slab_w=min_slab_w,
    )
    bounds = spec.initial_bounds(particles)
    state = sharded.distribute_particles(particles, spec, bounds=bounds)
    state = sharded.shard_state(state, mesh)
    step = sharded.build_sharded_step(spec, mesh)
    peak_frac = 0.0
    drops_by = {}
    with mesh:
        for frame in range(-settle, frames):
            cfg_f = (
                apply_motion_sin_x_cos_z(cfg, max(frame, 0)) if motion else cfg
            )
            dyn = dyn_params_of(cfg_f, np.float32)
            state, stats, bounds = step(state, dyn, bounds=bounds)
            counts = np.asarray(stats["alive_count"])
            peak_frac = max(peak_frac, counts.max() / max(counts.sum(), 1))
            for k in ("migrate_dropped", "migrate_deferred", "ghost_dropped"):
                drops_by[k] = drops_by.get(k, 0) + int(np.asarray(stats[k]).sum())
    drops = dict(drops_by)
    return state.to_soa(), spec, peak_frac, drops, np.asarray(bounds)


@pytest.mark.slow
def test_rebalance_matches_single():
    """Dynamic slab rebalancing preserves exact single-chip parity: ownership
    moves particles between devices, but ghost exchange gives every owned
    particle its full neighbourhood regardless of the partition."""
    mc, cfg, particles = dam_break(1200, solver_iter=3)
    # explicit cap: at this tiny scale one x-column holds most of the dam,
    # so the fractional default cannot cover the (column-granular) partition
    xs_m, spec, peak, drops, _ = run_sharded_rebalance(
        cfg, particles, 4, frames=2, cap_local=len(particles)
    )
    assert sum(drops.values()) == 0, drops
    xs_s = run_single(cfg, particles, frames=2)
    assert len(xs_m) == len(xs_s)
    a = xs_m.order_by_id()
    b = xs_s.order_by_id()
    np.testing.assert_array_equal(a.pid, b.pid)
    np.testing.assert_allclose(a.position, b.position, atol=0.1, rtol=0)
    np.testing.assert_allclose(a.velocity, b.velocity, atol=0.1, rtol=0)
    np.testing.assert_allclose(a.colour, b.colour, atol=2e-3, rtol=0)


@pytest.mark.slow
def test_migrate_deferral_recovers():
    """Emigrants beyond migrate_cap are DEFERRED (retained alive, outside
    the local grid for one frame), not dropped — force the deferral path
    with a tiny migrate_cap and a block of particles crossing a slab
    boundary at speed, then assert the backlog drains over subsequent
    frames with zero drops and full conservation (the
    deferral path previously had no test that exercised it)."""
    import dataclasses

    from pbf_sph_tpu.core.types import ParticleSoA

    mc, cfg, particles = dam_break(1200, solver_iter=2)
    n_dev = 2
    spec = sharded.ShardSpec.create(cfg, n_dev, len(particles), cfg.h,
                                    cap_local=len(particles))
    spec = dataclasses.replace(spec, migrate_cap=256)

    # park every particle half a column left of the slab boundary, moving
    # +x fast enough that advection crosses it on the first frame
    gx = spec.grid_global.dims[0]
    bcol = spec.slab_w  # boundary column (device 0 -> 1)
    h, scale = cfg.h, float(cfg.scale)
    min_ext_x = float(np.asarray(cfg.min_bound, np.float32)[0]) / scale - h * 2
    x_world = (min_ext_x + (bcol - 0.5) * h) * scale
    pos = particles.position.copy()
    pos[:, 0] = x_world + np.linspace(0, h * scale * 0.2, len(pos))
    vel = particles.velocity.copy()
    vel[:, 0] = 2.0 * h / float(np.float32(cfg.dt))  # ~2 columns/frame
    xs = ParticleSoA(particles.pid, particles.ptype, particles.mass,
                     pos, vel, particles.colour)

    mesh = Mesh(np.array(jax.devices()[:n_dev]), (sharded.AXIS,))
    state = sharded.shard_state(sharded.distribute_particles(xs, spec), mesh)
    step = sharded.build_sharded_step(spec, mesh)
    dyn = dyn_params_of(cfg, np.float32)
    deferred = []
    with mesh:
        for _ in range(12):
            state, stats = step(state, dyn)
            deferred.append(int(np.asarray(stats["migrate_deferred"]).sum()))
            assert int(np.asarray(stats["migrate_dropped"]).sum()) == 0
            if deferred[-1] == 0 and len(deferred) > 1:
                break
    assert deferred[0] > 0, "the deferral path was not exercised"
    assert deferred[-1] == 0, f"backlog never drained: {deferred}"
    # the backlog drains monotonically at migrate_cap per frame
    assert all(b - a >= 0 for a, b in zip(deferred[1:], deferred[:-1])), deferred
    # conservation: every particle survives deferral with its identity
    out = state.to_soa()
    assert len(out) == len(xs)
    np.testing.assert_array_equal(np.sort(out.pid), np.sort(xs.pid))
    assert np.isfinite(out.position).all() and np.isfinite(out.velocity).all()


@pytest.mark.slow
def test_rebalance_surface_matches_single():
    """Rebalancing + marching cubes coexist: the MC
    node partition follows the dynamic slab bounds (node/cell offsets are
    traced values derived from bounds, cube ownership is masked at
    bounds[d+1]*res), so the reference benchmark workload — sloshing bounds
    with the surface ON (`src/benchmark.cpp:29,33`) — can use the load
    balancer.  Triangle sets must match the single-chip run exactly."""
    import dataclasses

    from pbf_sph_tpu.core.scene import apply_motion_sin_x_cos_z

    mc, cfg, particles = simple_config_with_2_cubes(1500, 2, 500.0)
    # resolution 1.0: 8x smaller lattice, same parity logic (compile-bound
    # on CPU — this test was 17 min at resolution 2.0)
    cfg = cfg.replace(surface=dataclasses.replace(mc, resolution=1.0))
    frames = 2

    js = JaxSolver(h=cfg.h)
    xs_s = particles
    res = None
    for f in range(frames):
        res, xs_s = js.advance(apply_motion_sin_x_cos_z(cfg, f), Scene(), xs_s)
    T_ref = res.mesh.vs.shape[0] // 3
    assert T_ref > 0

    n_dev = 2
    mesh = Mesh(np.array(jax.devices()[:n_dev]), (sharded.AXIS,))
    spec = sharded.ShardSpec.create(
        cfg, n_dev, len(particles), cfg.h, rebalance=True,
        cap_local=len(particles),
    )
    assert spec.surface is not None
    bounds = spec.initial_bounds(particles)
    # the equal-count initial partition must differ from uniform slabs for
    # this test to exercise the dynamic node offsets
    assert not np.array_equal(bounds, spec.uniform_bounds())
    state = sharded.distribute_particles(particles, spec, bounds=bounds)
    state = sharded.shard_state(state, mesh)
    step = sharded.build_sharded_step(spec, mesh)
    with mesh:
        for f in range(frames):
            dyn = dyn_params_of(apply_motion_sin_x_cos_z(cfg, f), np.float32)
            state, stats, bounds = step(state, dyn, bounds=bounds)

    for k in ("migrate_dropped", "ghost_dropped", "mc_emit_overflow"):
        assert int(np.asarray(stats[k]).sum()) == 0, k
    counts = np.asarray(stats["tri_count"]).ravel()
    assert counts.sum() == T_ref
    cap3 = spec.surface.tri_capacity * 3
    vs = np.asarray(stats["mesh_vs"])

    rows = []
    for d, tc in enumerate(counts):
        seg = vs[:, d * cap3 : d * cap3 + 3 * int(tc)]
        rows.append(seg.T.reshape(int(tc), 9))
    got = np.concatenate(rows)
    want = res.mesh.vs.reshape(T_ref, 9)

    def canon(a):
        r = np.round(a, 3)
        return r[np.lexsort(r.T[::-1])]

    np.testing.assert_allclose(canon(got), canon(want), atol=2e-2, rtol=0)


@pytest.mark.slow
@pytest.mark.nightly
def test_rebalance_sloshing():
    """SURVEY hard part #4: 130 frames (one
    full ~126-frame sin(frame/20) period, past the frame-20-25 slam) of the
    oscillating-bounds benchmark motion (`src/sph.hpp:147-158`) on an
    8-device mesh with dynamic slab-width rebalancing.  Fixed slabs measured
    a 0.682 peak-slab fraction (5.46x uniform);
    equal-count boundaries must hold peak <= 2x uniform with a per-device
    capacity under half the whole set and ZERO drops.

    Scenario notes (round-3 measurements):
      * the partition is column-granular, so the scene must have many
        occupied x-columns per device — scaling 250 gives a 44-column grid
        vs 432 particles/column at the default 500 (where one column exceeds
        the per-device uniform share and NO x-partition can balance);
      * 60 settle frames first: cubes in free fall slam the moving wall as a
        coherent block and the clamp concentrates ~45% of all particles into
        1-2 grid columns for a few frames — a settled pool sloshes as a wave
        which IS balanceable;
      * capacities sized from the measured transient demand (per-frame
        sweep with the ghost_peak stat): the frame-20-25 wall slam peaks one
        device at 863 owned particles and 793 boundary-column ghosts, so
        cap_local=992 / ghost_cap=832 hold with zero drops AND zero
        deferrals (cap_local=832 measured 34 dropped immigrants)."""
    n_dev = 4
    mc, cfg, particles = simple_config_with_2_cubes(2000, 2, 250.0)
    xs_m, spec, peak, drops, bounds = run_sharded_rebalance(
        cfg, particles, n_dev, frames=130, motion=True, settle=60,
        cap_local=992, ghost_cap=832, min_slab_w=2,
    )
    assert spec.cap_local < 0.5 * len(particles)
    assert sum(drops.values()) == 0, drops
    assert len(xs_m) == len(particles)  # conservation (no sources/drains)
    assert peak <= 2.0 / n_dev, peak
    # boundaries remain monotone with the minimum width
    assert (np.diff(bounds) >= spec.min_slab_w).all()


# ---------------------------------------------------------------------------
# 2D tile decomposition (parallel/sharded2d.py)
# ---------------------------------------------------------------------------


def run_sharded2d(cfg, particles, nx, ny, frames, scene=None, cap_local=0):
    from pbf_sph_tpu.parallel import sharded2d

    mesh = sharded2d.make_mesh2d(nx, ny)
    spec = sharded2d.Shard2DSpec.create(
        cfg, nx, ny, particles, cfg.h, scene=scene, cap_local=cap_local,
    )
    state = sharded2d.shard_state_2d(
        sharded2d.distribute_particles_2d(particles, spec), mesh)
    step = sharded2d.build_sharded2d_step(spec, mesh)
    dyn = dyn_params_of(cfg, np.float32)
    scn = (scene_arrays_of(scene, spec.scene, np.float32)
           if scene is not None else None)
    stats = None
    with mesh:
        for _ in range(frames):
            state, stats = step(state, dyn, scn)
    return state.to_soa(), {k: np.asarray(v) for k, v in stats.items()}


@pytest.mark.slow
@pytest.mark.parametrize("nx,ny", [(2, 2), (4, 2)])
def test_sharded2d_matches_single(nx, ny):
    """The 2D tile step (two-phase migration + two-phase ghost halo incl.
    corners via the x-then-y trick) matches the single-chip run."""
    mc, cfg, particles = dam_break(1200, solver_iter=3)
    xs_m, stats = run_sharded2d(cfg, particles, nx, ny, frames=2)
    xs_s = run_single(cfg, particles, frames=2)
    assert stats["migrate_dropped"].sum() == 0
    assert stats["ghost_dropped"].sum() == 0
    assert stats["migrate_deferred"].sum() == 0
    assert len(xs_m) == len(xs_s)
    a = xs_m.order_by_id()
    b = xs_s.order_by_id()
    np.testing.assert_array_equal(a.pid, b.pid)
    np.testing.assert_allclose(a.position, b.position, atol=0.1, rtol=0)
    np.testing.assert_allclose(a.velocity, b.velocity, atol=0.1, rtol=0)
    np.testing.assert_allclose(a.colour, b.colour, atol=2e-3, rtol=0)


@pytest.mark.slow
def test_sharded2d_scene_and_queries_match_single():
    """Scene dynamics (wells/sources/drains) + psum-merged queries across
    the 2D mesh match the single-chip run."""
    mc, cfg, particles = dam_break(1200, solver_iter=2)
    lo = np.asarray(cfg.min_bound, np.float32)
    hi = np.asarray(cfg.max_bound, np.float32)
    mid = (lo + hi) / 2
    scene = Scene(
        wells=[Well(tag=0, centre=tuple(mid * 0.6), force=150.0)],
        sources=[Source(tag=777, centre=tuple(mid), velocity=(0, 1, 0),
                        colour=(1, 0, 0, 1), rate=9)],
        drains=[Drain(tag=0, centre=tuple(mid * 0.3), width=40.0)],
        queries=[Query(id=3, point=tuple(mid * 0.5))],
    )
    xs_m, stats = run_sharded2d(cfg, particles, 2, 2, frames=2, scene=scene)

    js = JaxSolver(h=cfg.h)
    xs_s = particles
    res = None
    for _ in range(2):
        res, xs_s = js.advance(cfg, scene, xs_s)

    assert stats["migrate_dropped"].sum() == 0
    assert stats["spawn_dropped"].sum() == 0
    assert len(xs_m) == len(xs_s)
    got = set(int(v) for v in stats["query_ids"][0] if v >= 0)
    want = set(res.queries[0].neighbours.tolist())
    assert got == want
    assert int(stats["query_counts"][0]) == len(want)


@pytest.mark.slow
def test_sharded2d_conserves_under_motion():
    """Sloshing bounds (the benchmark motion) drive particles across BOTH
    tile axes; the two-phase migration conserves every particle with zero
    drops at a fractional per-tile capacity."""
    from pbf_sph_tpu.core.scene import apply_motion_sin_x_cos_z

    mc, cfg, particles = dam_break(1600, solver_iter=1)
    from pbf_sph_tpu.parallel import sharded2d

    mesh = sharded2d.make_mesh2d(2, 2)
    spec = sharded2d.Shard2DSpec.create(
        cfg, 2, 2, particles, cfg.h, cap_local=1280)
    state = sharded2d.shard_state_2d(
        sharded2d.distribute_particles_2d(particles, spec), mesh)
    step = sharded2d.build_sharded2d_step(spec, mesh)
    ids = set()
    with mesh:
        for frame in range(12):
            dyn = dyn_params_of(apply_motion_sin_x_cos_z(cfg, frame), np.float32)
            state, stats = step(state, dyn)
            assert int(np.asarray(stats["migrate_dropped"]).sum()) == 0
            assert int(np.asarray(stats["ghost_dropped"]).sum()) == 0
            assert int(np.asarray(stats["alive_count"]).sum()) == len(particles)
    xs = state.to_soa()
    assert sorted(xs.pid.tolist()) == sorted(particles.pid.tolist())


@pytest.mark.slow
@pytest.mark.parametrize(
    "compacted",
    [False, pytest.param(True, marks=pytest.mark.nightly)])
def test_sharded2d_mc_matches_single(compacted):
    """Tile-local marching cubes on the 2D engine (node partition
    [bx*res, bx1*res] x [by*res, by1*res], cube ownership x < bx1*res AND
    y < by1*res, boundary/corner nodes fed by the two-phase halo) produces
    the same triangle set as the single-chip run.  `compacted=True` forces
    cube-compaction emission, certifying the tensor-product ownership mask
    survives the compaction."""
    import dataclasses
    from pbf_sph_tpu.parallel import sharded2d

    mc, cfg, particles = simple_config_with_2_cubes(1500, 2, 500.0)
    cfg = cfg.replace(surface=dataclasses.replace(mc, resolution=1.0))

    js = JaxSolver(h=cfg.h)
    res, _ = js.advance(cfg, Scene(), particles)
    T_ref = res.mesh.vs.shape[0] // 3
    assert T_ref > 0  # the scene must actually produce a surface

    mesh = sharded2d.make_mesh2d(2, 2)
    spec = sharded2d.Shard2DSpec.create(cfg, 2, 2, particles, cfg.h)
    assert spec.surface is not None
    if compacted:
        lvol = int(np.prod([s - 1 for s in spec.surface.sample]))
        spec = dataclasses.replace(
            spec, surface=dataclasses.replace(
                spec.surface, cube_cap=-(-lvol // 4 // 128) * 128))
    state = sharded2d.shard_state_2d(
        sharded2d.distribute_particles_2d(particles, spec), mesh)
    step = sharded2d.build_sharded2d_step(spec, mesh)
    dyn = dyn_params_of(cfg, np.float32)
    with mesh:
        state, stats = step(state, dyn)

    assert int(np.asarray(stats["mc_emit_overflow"]).sum()) == 0
    counts = np.asarray(stats["tri_count"]).ravel()
    assert counts.sum() == T_ref
    vs, ns, cs = sharded2d.gather_mesh(
        {k: np.asarray(v) for k, v in stats.items()}, spec)
    got = vs.reshape(T_ref, 9)
    want = res.mesh.vs.reshape(T_ref, 9)

    def canon(a):
        r = np.round(a, 3)
        return r[np.lexsort(r.T[::-1])]

    np.testing.assert_allclose(canon(got), canon(want), atol=2e-2, rtol=0)


def run_sharded2d_rebalance(cfg, particles, nx, ny, frames, motion=False,
                            cap_local=0):
    from pbf_sph_tpu.core.scene import apply_motion_sin_x_cos_z
    from pbf_sph_tpu.parallel import sharded2d

    mesh = sharded2d.make_mesh2d(nx, ny)
    spec = sharded2d.Shard2DSpec.create(
        cfg, nx, ny, particles, cfg.h, rebalance=True, cap_local=cap_local)
    bounds = (np.asarray(spec.xb, np.int32), np.asarray(spec.yb, np.int32))
    state = sharded2d.shard_state_2d(
        sharded2d.distribute_particles_2d(particles, spec), mesh)
    step = sharded2d.build_sharded2d_step(spec, mesh)
    peak_frac = 0.0
    drops = {}
    stats = None
    with mesh:
        for frame in range(frames):
            cfg_f = apply_motion_sin_x_cos_z(cfg, frame) if motion else cfg
            dyn = dyn_params_of(cfg_f, np.float32)
            state, stats, bounds = step(state, dyn, bounds=bounds)
            counts = np.asarray(stats["alive_count"])
            peak_frac = max(peak_frac, counts.max() / max(counts.sum(), 1))
            for k in ("migrate_dropped", "migrate_deferred", "ghost_dropped"):
                drops[k] = drops.get(k, 0) + int(np.asarray(stats[k]).sum())
    return (state.to_soa(), spec, peak_frac, drops,
            (np.asarray(bounds[0]), np.asarray(bounds[1])), stats)


@pytest.mark.slow
def test_sharded2d_rebalance_matches_single():
    """Dynamic tensor-product rebalancing preserves exact single-chip
    parity: per-axis cut moves change ownership, but the two-phase halo
    gives every owned particle its full neighbourhood regardless of the
    partition."""
    mc, cfg, particles = dam_break(1200, solver_iter=3)
    xs_m, spec, peak, drops, (xb, yb), _ = run_sharded2d_rebalance(
        cfg, particles, 2, 2, frames=2, cap_local=len(particles))
    assert sum(drops.values()) == 0, drops
    # cut arrays remain monotone with the minimum width
    assert (np.diff(xb) >= spec.min_w).all()
    assert (np.diff(yb) >= spec.min_w).all()
    xs_s = run_single(cfg, particles, frames=2)
    assert len(xs_m) == len(xs_s)
    a = xs_m.order_by_id()
    b = xs_s.order_by_id()
    np.testing.assert_array_equal(a.pid, b.pid)
    np.testing.assert_allclose(a.position, b.position, atol=0.1, rtol=0)
    np.testing.assert_allclose(a.velocity, b.velocity, atol=0.1, rtol=0)
    np.testing.assert_allclose(a.colour, b.colour, atol=2e-3, rtol=0)


@pytest.mark.slow
@pytest.mark.nightly
def test_sharded2d_rebalance_surface_matches_single():
    """Rebalancing + tile-local marching cubes coexist on the 2D engine:
    the node partition follows the dynamic cuts (node/cell offsets traced
    from xb/yb, cube ownership masked at xb[mx+1]*res AND yb[my+1]*res).
    Triangle sets must match the single-chip run exactly under the
    benchmark's sloshing bounds (`src/benchmark.cpp:29,33`)."""
    import dataclasses

    from pbf_sph_tpu.core.scene import apply_motion_sin_x_cos_z
    from pbf_sph_tpu.parallel import sharded2d

    mc, cfg, particles = simple_config_with_2_cubes(1500, 2, 500.0)
    cfg = cfg.replace(surface=dataclasses.replace(mc, resolution=1.0))
    frames = 2

    js = JaxSolver(h=cfg.h)
    xs_s = particles
    res = None
    for f in range(frames):
        res, xs_s = js.advance(apply_motion_sin_x_cos_z(cfg, f), Scene(), xs_s)
    T_ref = res.mesh.vs.shape[0] // 3
    assert T_ref > 0

    mesh = sharded2d.make_mesh2d(2, 2)
    spec = sharded2d.Shard2DSpec.create(
        cfg, 2, 2, particles, cfg.h, rebalance=True,
        cap_local=len(particles))
    assert spec.surface is not None
    bounds = (np.asarray(spec.xb, np.int32), np.asarray(spec.yb, np.int32))
    state = sharded2d.shard_state_2d(
        sharded2d.distribute_particles_2d(particles, spec), mesh)
    step = sharded2d.build_sharded2d_step(spec, mesh)
    with mesh:
        for f in range(frames):
            dyn = dyn_params_of(apply_motion_sin_x_cos_z(cfg, f), np.float32)
            state, stats, bounds = step(state, dyn, bounds=bounds)

    for k in ("migrate_dropped", "ghost_dropped", "mc_emit_overflow"):
        assert int(np.asarray(stats[k]).sum()) == 0, k
    counts = np.asarray(stats["tri_count"]).ravel()
    assert counts.sum() == T_ref
    vs, ns, cs = sharded2d.gather_mesh(
        {k: np.asarray(v) for k, v in stats.items()}, spec)
    got = vs.reshape(T_ref, 9)
    want = res.mesh.vs.reshape(T_ref, 9)

    def canon(a):
        r = np.round(a, 3)
        return r[np.lexsort(r.T[::-1])]

    np.testing.assert_allclose(canon(got), canon(want), atol=2e-2, rtol=0)


@pytest.mark.slow
@pytest.mark.nightly
def test_sharded2d_rebalance_conserves_under_motion():
    """Sloshing bounds with dynamic tensor-product rebalancing at a
    fractional per-tile capacity: zero drops, full conservation, and the
    cuts stay monotone/feasible while they move."""
    mc, cfg, particles = dam_break(1600, solver_iter=1)
    xs, spec, peak, drops, (xb, yb), _ = run_sharded2d_rebalance(
        cfg, particles, 2, 2, frames=12, motion=True, cap_local=1280)
    assert spec.cap_local < len(particles)
    assert sum(drops.values()) == 0, drops
    assert len(xs) == len(particles)
    assert sorted(xs.pid.tolist()) == sorted(particles.pid.tolist())
    assert (np.diff(xb) >= spec.min_w).all()
    assert (np.diff(yb) >= spec.min_w).all()
