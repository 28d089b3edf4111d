"""Capacity-growth policy, backend selection and the frozen-grid extent
guard."""

import pytest

from pbf_sph_tpu.core.configs import dam_break
from pbf_sph_tpu.core.types import Scene
from pbf_sph_tpu.models import make_solver
from pbf_sph_tpu.models.growth import growth_changes
from pbf_sph_tpu.models.jax_solver import JaxSolver


def test_pallas_backend_is_gone():
    with pytest.raises(ValueError, match="unknown impl 'pallas'"):
        make_solver("pallas")


@pytest.mark.parametrize("out, grown", [
    (dict(max_occupancy=17), set()),
    (dict(max_occupancy=60), {"cell_capacity"}),
    # outputs of older steps carried strip-overflow counters; the policy
    # ignores them and never answers with a strip capacity
    (dict(max_occupancy=17, strip_overflow=5, mc_strip_overflow=7), set()),
    (dict(max_occupancy=17, query_overflow=3), {"scene"}),
])
def test_growth_changes_keys(out, grown):
    _, cfg, xs = dam_break(500, surface=False)
    spec = JaxSolver(h=cfg.h).make_spec(cfg, Scene(), capacity=512)
    changes = growth_changes(spec, out)
    assert set(changes) == grown
    assert not any("strip" in k or "pallas" in k for k in changes)
    if "cell_capacity" in changes:
        assert changes["cell_capacity"] >= 60


def test_extent_guard_catches_resize_not_translation():
    """The frozen-grid extent guard must fire on a genuinely resized domain
    and stay quiet under the benchmark's translation-only motion — including
    motion phases where span/h sits exactly on an integer boundary (2cubes at
    scale 500 hits 23.999998 vs 24.000000 between host division and a
    compiler's reciprocal-multiply lowering; the guard carries 1e-3-cell
    slack)."""
    from pbf_sph_tpu.core.scene import (
        apply_motion_sin_x_cos_z,
        simple_config_with_2_cubes,
    )
    from pbf_sph_tpu.models.jax_solver import dyn_params_of

    _, cfg, xs = simple_config_with_2_cubes(600, 2, 500.0)
    solver = JaxSolver(h=cfg.h)
    spec, state, scn = solver.prepare(cfg, Scene(), xs)

    # translation-only motion: every phase of the benchmark oscillation fits
    for frame in range(8):
        c = apply_motion_sin_x_cos_z(cfg, frame)
        _, out = solver.step_device(spec, state, dyn_params_of(c, solver.dtype), scn)
        assert bool(out["extent_ok"]), f"false positive at motion frame {frame}"

    # a real resize (domain grown by 25%) must fail loudly
    grown = cfg.replace(max_bound=tuple(v * 1.25 for v in cfg.max_bound))
    _, out = solver.step_device(spec, state, dyn_params_of(grown, solver.dtype), scn)
    assert not bool(out["extent_ok"])
