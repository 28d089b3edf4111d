"""Cross-backend parity: the jitted XLA engine vs the NumPy oracle.

This is the fidelity anchor: identical dam-break initial
conditions, per-frame state agreement within fp32 tolerance (accumulation
order differs between backends, so exact bitwise equality is not expected).
"""

import numpy as np
import pytest

from pbf_sph_tpu.core.scene import apply_motion_sin_x_cos_z, simple_config_with_2_cubes
from pbf_sph_tpu.core.types import Drain, Query, Scene, Source, Well
from pbf_sph_tpu.models.jax_solver import JaxSolver
from pbf_sph_tpu.models.numpy_solver import NumpySolver


def run_both(cfg, scene, particles, frames=1, motion=True):
    js = JaxSolver(h=cfg.h)
    ns = NumpySolver(h=cfg.h)
    xs_j = particles
    xs_n = particles
    res_j = res_n = None
    for f in range(frames):
        c = apply_motion_sin_x_cos_z(cfg, f) if motion else cfg
        res_j, xs_j = js.advance(c, scene, xs_j)
        res_n, xs_n = ns.advance(c, scene, xs_n)
    return (res_j, xs_j.order_by_id()), (res_n, xs_n.order_by_id())


def assert_state_close(xs_j, xs_n, pos_atol=0.05, vel_atol=0.05, col_atol=1e-3):
    np.testing.assert_array_equal(xs_j.pid, xs_n.pid)
    np.testing.assert_array_equal(xs_j.ptype, xs_n.ptype)
    np.testing.assert_allclose(xs_j.position, xs_n.position, atol=pos_atol, rtol=0)
    np.testing.assert_allclose(xs_j.velocity, xs_n.velocity, atol=vel_atol, rtol=0)
    np.testing.assert_allclose(xs_j.colour, xs_n.colour, atol=col_atol, rtol=0)


@pytest.mark.slow
def test_single_frame_parity():
    mc, cfg, particles = simple_config_with_2_cubes(2000, 3, 500.0)
    (rj, xj), (rn, xn) = run_both(cfg, Scene(), particles, frames=1)
    assert_state_close(xj, xn, pos_atol=0.02, vel_atol=0.02)


@pytest.mark.slow
def test_three_frame_parity():
    mc, cfg, particles = simple_config_with_2_cubes(2000, 3, 500.0)
    (rj, xj), (rn, xn) = run_both(cfg, Scene(), particles, frames=3)
    assert_state_close(xj, xn, pos_atol=0.2, vel_atol=0.5, col_atol=5e-3)


@pytest.mark.slow
def test_six_iteration_parity():
    mc, cfg, particles = simple_config_with_2_cubes(2000, 6, 500.0)
    (rj, xj), (rn, xn) = run_both(cfg, Scene(), particles, frames=1)
    assert_state_close(xj, xn, pos_atol=0.05, vel_atol=0.1)


@pytest.mark.slow
def test_density_parity():
    """Fidelity criterion: per-particle densities of the two
    backends agree within fp32 tolerance on identical ICs."""
    import jax.numpy as jnp

    from pbf_sph_tpu.models import numpy_solver as nsm
    from pbf_sph_tpu.ops.kernels import poly6, poly6_factor

    mc, cfg, particles = simple_config_with_2_cubes(2000, 3, 500.0)
    js = JaxSolver(h=cfg.h)
    ns = NumpySolver(h=cfg.h)
    _, xj = js.advance(cfg, Scene(), particles)
    _, xn = ns.advance(cfg, Scene(), particles)
    xj, xn = xj.order_by_id(), xn.order_by_id()

    # evaluate SPH density of both outputs with one (NumPy) evaluator
    def density(xs):
        f = np.float32
        h = f(cfg.h)
        pos = xs.position / f(cfg.scale)
        from scipy.spatial import cKDTree

        t = cKDTree(pos)
        pairs = t.query_pairs(float(h), output_type="ndarray")
        p6f = f(poly6_factor(cfg.h))
        rho = np.full(len(xs), p6f * h**6, np.float64)  # self term
        d = np.linalg.norm(pos[pairs[:, 0]] - pos[pairs[:, 1]], axis=1).astype(f)
        w = poly6(d, h, p6f, np)
        np.add.at(rho, pairs[:, 0], w)
        np.add.at(rho, pairs[:, 1], w)
        return rho * xs.mass

    rho_j = density(xj)
    rho_n = density(xn)
    np.testing.assert_allclose(rho_j, rho_n, rtol=2e-3)


@pytest.mark.slow
def test_scene_parity():
    mc, cfg, particles = simple_config_with_2_cubes(1000, 3, 500.0)
    scene = Scene(
        wells=[Well(tag=0, centre=(150.0, 30.0, 150.0), force=200.0)],
        sources=[Source(tag=777, centre=(500, 400, 500), velocity=(0, 1, 0), colour=(1, 0, 0, 1), rate=9)],
        drains=[Drain(tag=0, centre=(650, 60, 650), width=80.0)],
        queries=[Query(id=3, point=(150, 30, 150))],
    )
    (rj, xj), (rn, xn) = run_both(cfg, scene, particles, frames=1, motion=False)
    assert len(xj) == len(xn)

    # source-spawned particles share one tag id (reference semantics,
    # `src/omp/ompsph.hpp:102`), so order among equal ids is ambiguous;
    # canonicalize by (id, position)
    def canon(xs):
        # round sort keys so sub-tolerance fp noise cannot flip the ordering
        r = np.round(xs.position, 1)
        o = np.lexsort((r[:, 2], r[:, 1], r[:, 0], xs.pid))
        from pbf_sph_tpu.core.types import ParticleSoA

        return ParticleSoA(xs.pid[o], xs.ptype[o], xs.mass[o],
                           xs.position[o], xs.velocity[o], xs.colour[o])

    assert_state_close(canon(xj), canon(xn), pos_atol=0.05, vel_atol=0.05)
    assert len(rj.queries) == len(rn.queries) == 1
    assert set(rj.queries[0].neighbours.tolist()) == set(rn.queries[0].neighbours.tolist())


@pytest.mark.slow
def test_mesh_parity():
    mc, cfg, particles = simple_config_with_2_cubes(2000, 3, 500.0)
    cfg = cfg.replace(surface=mc)
    (rj, xj), (rn, xn) = run_both(cfg, Scene(), particles, frames=1)
    tj, tn = len(rj.mesh.vs) // 3, len(rn.mesh.vs) // 3
    assert tj > 0
    # counts may differ by isolated lattice values straddling the isolevel
    assert abs(tj - tn) <= max(3, 0.01 * tn)

    # triangle sets match: compare sorted centroid multisets coarsely
    def centroids(mesh):
        c = mesh.vs.reshape(-1, 3, 3).mean(axis=1)
        return {tuple(v) for v in np.round(c, 1).tolist()}

    cj, cn = centroids(rj.mesh), centroids(rn.mesh)
    iou = len(cj & cn) / max(1, len(cj | cn))
    assert iou > 0.95
