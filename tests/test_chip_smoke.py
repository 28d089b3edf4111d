"""chip_smoke.py's CPU-reachable parts: the device check and the host-side
comparisons that decide its phases."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

from pbf_sph_tpu.core.scene import simple_config_with_2_cubes
from pbf_sph_tpu.core.types import Scene


def _load():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m


def test_device_check_fails_on_cpu(capsys):
    m = _load()
    with pytest.raises(SystemExit) as e:
        m.require_gpu()
    assert e.value.code != 0
    assert "no GPU" in capsys.readouterr().err


@pytest.fixture(scope="module")
def two_cube_frame():
    """One frame of a tiny two-cube scene on the JAX engine and the NumPy
    oracle from the same input."""
    from pbf_sph_tpu.models.jax_solver import JaxSolver
    from pbf_sph_tpu.models.numpy_solver import NumpySolver

    _, cfg, xs = simple_config_with_2_cubes(300, 2, 500.0)
    _, xj = JaxSolver(h=cfg.h).advance(cfg, Scene(), xs)
    _, xn = NumpySolver(h=cfg.h).advance(cfg, Scene(), xs)
    return cfg, xj, xn


@pytest.mark.parametrize("perturb", [0.0, 0.5])
def test_parity_comparison(two_cube_frame, perturb):
    m = _load()
    cfg, xj, xn = two_cube_frame
    if perturb == 0.0:
        err = m.compare_states(xj, xn)
        assert err["position"] <= m.POS_ATOL
        assert m.compare_density(xj, xn, cfg) <= m.RHO_RTOL
    else:
        bad = xj.copy()
        bad.position[len(bad) // 2, 1] += perturb
        with pytest.raises(m.SmokeFailure, match="position"):
            m.compare_states(bad, xn)


class _Surface:
    tri_capacity = 100


class _Spec:
    cell_capacity = 48
    surface = _Surface()


_GOOD = dict(alive_count=1000, max_occupancy=17, extent_ok=True,
             spawn_dropped=0, query_overflow=0, mc_emit_overflow=0,
             tri_count=40)


@pytest.mark.parametrize("change, message", [
    ({}, None),
    ({"alive_count": 999}, "alive count"),
    ({"max_occupancy": 49}, "occupancy"),
    ({"extent_ok": False}, "extent_ok"),
    ({"mc_emit_overflow": 3}, "mc_emit_overflow"),
    ({"tri_count": 0}, "tri_count"),
])
def test_frame_output_checks(change, message):
    m = _load()
    out = {k: np.asarray(v) for k, v in {**_GOOD, **change}.items()}
    if message is None:
        m.check_outputs(out, 1000, _Spec())
    else:
        with pytest.raises(m.SmokeFailure, match=message):
            m.check_outputs(out, 1000, _Spec())
