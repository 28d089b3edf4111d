#!/usr/bin/env python
"""Smoke test of the engine on the GPU, through the entry points users call.

    python chip_smoke.py             # one card: parity, full size, the CLI
    python chip_smoke.py --cards 4   # four cards: the sharded engines only

One card, in one process:
  1. device check — fails unless JAX's default backend is the GPU;
  2. parity on the card — one `parity32k` frame through `JaxSolver.advance`
     against `NumpySolver.advance` on the host from the same input, then one
     `bench20k` frame with the surface on, comparing its mesh with the
     oracle's marching cubes of the same output particles;
  3. full size — `dam1m` (1,008,028 particles, 6 iterations) through
     `prepare`/`step_device` after the growth-converged warmup, then timed
     frames with conservation, overflow, extent and bounds checks; `mc128k`
     with the surface on for a few frames;
  4. the reference workload through `cli.main` (bench20k, 20 + 5 frames).

`--timings` adds each step's compile time from the persistent cache and the
per-phase table of `models/timed.py` at dam1m and mc128k.

`--cards 4` runs the 1D slab engine (4 slabs) and the 2D tile engine (2x2)
at `dam1m` with rebalancing, each compared after one frame with the
single-card step on card 0 from the same input, then a few frames of each
through `cli.main --multichip` with conservation checks.

Any failed check raises, so the exit code is non-zero and no result line is
printed.  The last line of standard output is one JSON object naming the
device as JAX reports it.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent

# one-frame parity tolerances against the NumPy oracle (the same as
# tests/test_jax_vs_oracle.py).  Summation order and FMA contraction differ
# between the device and the host; no float32 matrix product is on the path,
# so TF32 does not enter.
POS_ATOL = 0.02       # world units, after one frame
VEL_ATOL = 0.02
COL_ATOL = 1e-3
RHO_RTOL = 2e-3       # SPH density of the output positions
# mesh: triangle counts may differ by lattice values straddling the isolevel
TRI_SLACK = (3, 0.01)  # |tj - tn| <= max(3, 1% of tn)
MIN_CENTROID_IOU = 0.95
# sharded vs single-card step after one frame (tests/test_sharded.py)
SHARD_POS_ATOL = 0.1
SHARD_VEL_ATOL = 0.1
SHARD_COL_ATOL = 2e-3


class SmokeFailure(AssertionError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(*a) -> None:
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# device
# ---------------------------------------------------------------------------


def require_gpu(count: int = 1):
    """Return the first `count` GPU devices; exit non-zero without them."""
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        print(f"chip_smoke: no GPU — JAX's default backend is {backend!r}",
              file=sys.stderr)
        raise SystemExit(1)
    devs = jax.devices()
    if len(devs) < count:
        print(f"chip_smoke: needs {count} GPUs, JAX sees {len(devs)}",
              file=sys.stderr)
        raise SystemExit(1)
    return devs[:count]


def card_name_and_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def peak_bytes(dev) -> int:
    return int(dev.memory_stats()["peak_bytes_in_use"])


# ---------------------------------------------------------------------------
# comparisons (host side; unit-tested on the CPU)
# ---------------------------------------------------------------------------


def compare_states(xj, xn, pos_atol=POS_ATOL, vel_atol=VEL_ATOL,
                   col_atol=COL_ATOL) -> dict:
    """Max abs error per field of two particle sets (matched by id); raises
    SmokeFailure beyond the tolerances."""
    a, b = xj.order_by_id(), xn.order_by_id()
    check(len(a) == len(b), f"particle counts differ: {len(a)} vs {len(b)}")
    check(np.array_equal(a.pid, b.pid), "particle ids differ")
    check(np.isfinite(a.position).all() and np.isfinite(a.velocity).all(),
          "non-finite positions or velocities")
    err = {
        "position": float(np.abs(a.position - b.position).max(initial=0.0)),
        "velocity": float(np.abs(a.velocity - b.velocity).max(initial=0.0)),
        "colour": float(np.abs(a.colour - b.colour).max(initial=0.0)),
    }
    for k, tol in (("position", pos_atol), ("velocity", vel_atol),
                   ("colour", col_atol)):
        check(err[k] <= tol, f"{k} max abs error {err[k]!r} > {tol}")
    return err


def sph_density(xs, cfg) -> np.ndarray:
    """Per-particle SPH density of a particle set (poly6 over pairs within h,
    self term included), in float64 — one evaluator for both outputs."""
    from scipy.spatial import cKDTree

    from pbf_sph_tpu.ops.kernels import poly6, poly6_factor

    f = np.float32
    h = f(cfg.h)
    pos = xs.position / f(cfg.scale)
    pairs = cKDTree(pos).query_pairs(float(h), output_type="ndarray")
    p6f = f(poly6_factor(cfg.h))
    rho = np.full(len(xs), p6f * h**6, np.float64)
    d = np.linalg.norm(pos[pairs[:, 0]] - pos[pairs[:, 1]], axis=1).astype(f)
    w = poly6(d, h, p6f, np)
    np.add.at(rho, pairs[:, 0], w)
    np.add.at(rho, pairs[:, 1], w)
    return rho * xs.mass


def compare_density(xj, xn, cfg, rtol=RHO_RTOL) -> float:
    rj = sph_density(xj.order_by_id(), cfg)
    rn = sph_density(xn.order_by_id(), cfg)
    rel = float((np.abs(rj - rn) / np.abs(rn)).max(initial=0.0))
    check(rel <= rtol, f"density max rel error {rel!r} > {rtol}")
    return rel


def compare_meshes(mj, mn) -> dict:
    """Triangle count and centroid-set agreement of two meshes."""
    tj, tn = len(mj.vs) // 3, len(mn.vs) // 3
    check(tj > 0, "the device mesh is empty")

    def centroids(m):
        c = m.vs.reshape(-1, 3, 3).mean(axis=1)
        return {tuple(v) for v in np.round(c, 1).tolist()}

    cj, cn = centroids(mj), centroids(mn)
    iou = len(cj & cn) / max(1, len(cj | cn))
    slack = max(TRI_SLACK[0], TRI_SLACK[1] * tn)
    check(abs(tj - tn) <= slack,
          f"triangle counts {tj} vs {tn} differ by more than {slack}")
    check(iou > MIN_CENTROID_IOU,
          f"triangle centroid IoU {iou!r} <= {MIN_CENTROID_IOU}")
    return {"triangles": tj, "oracle_triangles": tn, "centroid_iou": iou}


def check_outputs(out, n_alive: int, spec) -> None:
    """A device-resident frame's outputs (host values): no particle lost,
    no capacity overflowed, the grid extent held."""
    check(int(out["alive_count"]) == n_alive,
          f"alive count {int(out['alive_count'])} != {n_alive}")
    check(int(out["max_occupancy"]) <= spec.cell_capacity,
          f"cell occupancy {int(out['max_occupancy'])} > capacity "
          f"{spec.cell_capacity}")
    check(bool(out["extent_ok"]), "extent_ok is false")
    check(int(out["spawn_dropped"]) == 0, "spawned particles dropped")
    check(int(out["query_overflow"]) == 0, "query overflow")
    if spec.surface is not None:
        check(int(out["mc_emit_overflow"]) == 0, "mc_emit_overflow")
        check(0 < int(out["tri_count"]) <= spec.surface.tri_capacity,
              f"tri_count {int(out['tri_count'])} outside "
              f"(0, {spec.surface.tri_capacity}]")


def check_in_bounds(xs, cfg) -> None:
    """Finite positions inside the domain, up to the rounding of the
    clamp-then-rescale in the delta and finalise phases."""
    pos = xs.position
    check(np.isfinite(pos).all(), "non-finite positions")
    lo, hi = np.asarray(cfg.min_bound), np.asarray(cfg.max_bound)
    eps = 1e-5 * (hi - lo)
    check(((pos >= lo - eps) & (pos <= hi + eps)).all(),
          f"positions outside [{lo}, {hi}]: {pos.min(0)} .. {pos.max(0)}")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_parity() -> None:
    from pbf_sph_tpu.core.configs import WORKLOADS
    from pbf_sph_tpu.core.types import Scene
    from pbf_sph_tpu.models.jax_solver import JaxSolver
    from pbf_sph_tpu.models.numpy_solver import NumpySolver

    _, cfg, xs = WORKLOADS["parity32k"]()
    t0 = time.perf_counter()
    _, xj = JaxSolver(h=cfg.h).advance(cfg, Scene(), xs)
    t1 = time.perf_counter()
    _, xn = NumpySolver(h=cfg.h).advance(cfg, Scene(), xs)
    t2 = time.perf_counter()
    err = compare_states(xj, xn)
    err["density_rel"] = compare_density(xj, xn, cfg)
    log(f"parity32k ({len(xs)} particles, {cfg.iteration} iterations, one "
        f"frame): max abs error {err} (tolerances pos {POS_ATOL}, vel "
        f"{VEL_ATOL}, colour {COL_ATOL}, density rtol {RHO_RTOL}); "
        f"device advance {t1 - t0:.3f} s incl. compile, oracle {t2 - t1:.3f} s")

    # bench20k starts strongly compressed (spacing 0.44 h): within one frame
    # fp32 summation order alone moves particles apart, on the CPU as on the
    # card, so the oracle extracts its surface from the device frame's own
    # output particles over the cell table both build from the same input
    _, cfg, xs = WORKLOADS["bench20k"]()
    rj, xj = JaxSolver(h=cfg.h).advance(cfg, Scene(), xs)
    mesh = compare_meshes(rj.mesh, NumpySolver(h=cfg.h).surface_of(cfg, xs, xj))
    log(f"bench20k ({len(xs)} particles, surface on, one frame): device "
        f"mesh vs the oracle's marching cubes of the same particles: {mesh}")


def _abstract(tree):
    import jax

    return jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(np.shape(x), x.dtype), tree)


def phase_full_size(workload: str, warmup: int, frames: int,
                    warm_compile: bool = False) -> None:
    import jax

    from pbf_sph_tpu.core.configs import WORKLOADS
    from pbf_sph_tpu.core.types import Scene
    from pbf_sph_tpu.models.growth import settle
    from pbf_sph_tpu.models.jax_solver import JaxSolver, dyn_params_of

    dev = jax.devices()[0]
    _, cfg, xs = WORKLOADS[workload]()
    n = len(xs)
    solver = JaxSolver(h=cfg.h)
    spec, state, scn = solver.prepare(cfg, Scene(), xs)
    dyn = jax.device_put(dyn_params_of(cfg, solver.dtype))

    t0 = time.perf_counter()
    compiled = solver.get_step(spec).lower(
        *_abstract((state, dyn, scn))).compile()
    compile_s = time.perf_counter() - t0
    ma = compiled.memory_analysis()
    log(f"{workload}: compile {compile_s:.3f} s; memory_analysis: "
        f"arguments {ma.argument_size_in_bytes} B, outputs "
        f"{ma.output_size_in_bytes} B, aliased {ma.alias_size_in_bytes} B, "
        f"temporaries {ma.temp_size_in_bytes} B, code "
        f"{ma.generated_code_size_in_bytes} B")
    if warm_compile:
        jax.clear_caches()
        t0 = time.perf_counter()
        solver.get_step(spec).lower(*_abstract((state, dyn, scn))).compile()
        log(f"{workload}: compile again from the persistent cache "
            f"{time.perf_counter() - t0:.3f} s")

    t0 = time.perf_counter()
    spec, state = settle(solver, spec, state, dyn, scn, xs, warmup)
    jax.block_until_ready(state)
    log(f"{workload}: growth-converged warmup of {warmup} frames "
        f"{time.perf_counter() - t0:.3f} s (cell capacity "
        f"{spec.cell_capacity})")

    outs = []
    t0 = time.perf_counter()
    for _ in range(frames):
        state, out = solver.step_device(spec, state, dyn, scn)
        outs.append(out)
    jax.block_until_ready((state, outs))
    elapsed = time.perf_counter() - t0
    for out in outs:
        check_outputs(jax.device_get(out), n, spec)
    check_in_bounds(state.to_soa(), cfg)
    ms = 1000.0 * elapsed / frames
    extra = ""
    if spec.surface is not None:
        extra = f", triangles {int(outs[-1]['tri_count'])}"
    log(f"{workload}: {n} particles, {cfg.iteration} iterations, "
        f"surface {'on' if spec.surface else 'off'}: {frames} frames "
        f"{ms:.3f} ms/step, {n * frames / elapsed:.6e} particle-steps/s, "
        f"max occupancy {max(int(o['max_occupancy']) for o in outs)}"
        f"{extra}; peak_bytes_in_use {peak_bytes(dev)}")


def phase_timings(workload: str) -> None:
    """The per-phase table of `models/timed.py` (one jit per phase, a device
    sync between phases); the second frame is printed, the first compiles."""
    from pbf_sph_tpu.core.configs import WORKLOADS
    from pbf_sph_tpu.core.types import Scene
    from pbf_sph_tpu.models.jax_solver import JaxSolver
    from pbf_sph_tpu.models.timed import advance_timed

    _, cfg, xs = WORKLOADS[workload]()
    solver = JaxSolver(h=cfg.h)
    _, xs1, _ = advance_timed(solver, cfg, Scene(), xs)
    _, xs2, watch = advance_timed(solver, cfg, Scene(), xs1)
    check(len(xs2) == len(xs), f"{workload}: timed frames lost particles")
    log(f"{workload} per-phase times (second timed frame):\n{watch}")


def phase_cli() -> None:
    from pbf_sph_tpu import cli

    out_dir = REPO / "out_chip_smoke"
    shutil.rmtree(out_dir, ignore_errors=True)
    rc = cli.main(["--impl", "jax", "--workload", "bench20k", "--iter", "20",
                   "--warmup", "5", "--output", str(out_dir / "{impl}")])
    check(rc == 0, f"cli.main returned {rc}")
    for name in ("cloud.ply", "mesh.obj"):
        f = out_dir / "jax" / name
        check(f.exists() and f.stat().st_size > 0, f"{f} missing or empty")
    log(f"cli bench20k: wrote {sorted(p.name for p in (out_dir / 'jax').iterdir())}")


def _run_cli_counted(argv, n: int) -> None:
    """cli.main with its output echoed; the final particle count must be n."""
    from pbf_sph_tpu import cli

    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
    finally:
        log(buf.getvalue().rstrip())
    text = buf.getvalue()
    check(rc == 0, f"cli.main {argv} returned {rc}")
    final = int(text.split("Final Particle count :")[1].split()[0])
    check(final == n, f"cli {argv}: {final} particles at the end, {n} built")


def phase_multicard(devs) -> None:
    import jax
    from jax.sharding import Mesh

    from pbf_sph_tpu.core.configs import WORKLOADS
    from pbf_sph_tpu.core.types import Scene
    from pbf_sph_tpu.models.jax_solver import JaxSolver, dyn_params_of
    from pbf_sph_tpu.parallel import sharded, sharded2d

    _, cfg, xs = WORKLOADS["dam1m"]()
    n = len(xs)
    dyn = dyn_params_of(cfg, np.float32)

    t0 = time.perf_counter()
    _, x_single = JaxSolver(h=cfg.h).advance(cfg, Scene(), xs)
    log(f"single card (card 0) one dam1m frame: "
        f"{time.perf_counter() - t0:.3f} s incl. compile")

    def spread(label, state, stats):
        per_dev = np.asarray(stats["alive_count"]).ravel()
        used = {d for d in state.position.sharding.device_set}
        check(used == set(devs), f"{label}: state on {used}, not {devs}")
        check((per_dev > 0).all(), f"{label}: particles per card {per_dev}")
        check(int(per_dev.sum()) == n, f"{label}: {per_dev.sum()} != {n}")
        for k in ("migrate_dropped", "migrate_deferred", "ghost_dropped"):
            check(int(np.asarray(stats[k]).sum()) == 0, f"{label}: {k}")
        check(np.asarray(stats["extent_ok"]).all(), f"{label}: extent_ok")
        log(f"{label}: particles per card {per_dev.tolist()}, "
            f"peak_bytes_in_use per card {[peak_bytes(d) for d in devs]}")

    # 1D slabs over the 4 cards
    mesh = Mesh(np.array(devs), (sharded.AXIS,))
    spec = sharded.ShardSpec.create(cfg, len(devs), n, cfg.h, rebalance=True)
    bounds = spec.initial_bounds(xs)
    state = sharded.shard_state(
        sharded.distribute_particles(xs, spec, bounds=bounds), mesh)
    t0 = time.perf_counter()
    state, stats, bounds = sharded.build_sharded_step(spec, mesh)(
        state, dyn, bounds=bounds)
    jax.block_until_ready(state)
    log(f"1D slabs x{len(devs)}: first frame {time.perf_counter() - t0:.3f} s "
        f"incl. compile, bounds {np.asarray(bounds).tolist()}")
    spread(f"1D slabs x{len(devs)}", state, stats)
    err = compare_states(state.to_soa(), x_single, SHARD_POS_ATOL,
                         SHARD_VEL_ATOL, SHARD_COL_ATOL)
    log(f"1D slabs vs single card after one frame: max abs error {err}")
    del state, stats

    # 2D tiles on a 2x2 mesh
    mesh2 = Mesh(np.array(devs).reshape(2, 2), (sharded2d.AXX, sharded2d.AXY))
    spec2 = sharded2d.Shard2DSpec.create(cfg, 2, 2, xs, cfg.h, rebalance=True)
    b2 = (np.asarray(spec2.xb, np.int32), np.asarray(spec2.yb, np.int32))
    state = sharded2d.shard_state_2d(
        sharded2d.distribute_particles_2d(xs, spec2, bounds=b2), mesh2)
    t0 = time.perf_counter()
    state, stats, b2 = sharded2d.build_sharded2d_step(spec2, mesh2)(
        state, dyn, bounds=b2)
    jax.block_until_ready(state)
    log(f"2D tiles 2x2: first frame {time.perf_counter() - t0:.3f} s incl. "
        f"compile, cuts {np.asarray(b2[0]).tolist()} x "
        f"{np.asarray(b2[1]).tolist()}")
    spread("2D tiles 2x2", state, stats)
    err = compare_states(state.to_soa(), x_single, SHARD_POS_ATOL,
                         SHARD_VEL_ATOL, SHARD_COL_ATOL)
    log(f"2D tiles vs single card after one frame: max abs error {err}")
    del state, stats

    out_dir = REPO / "out_chip_smoke"
    shutil.rmtree(out_dir, ignore_errors=True)
    for layout in (str(len(devs)), "2x2"):
        _run_cli_counted(
            ["--impl", "jax", "--workload", "dam1m", "--multichip", layout,
             "--rebalance", "--iter", "5", "--warmup", "2",
             "--output", str(out_dir / ("mc_" + layout))], n)


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cards", type=int, choices=(1, 4), default=1,
                   help="1: the single-card phases; 4: the sharded engines "
                        "on four cards, and no other phase")
    p.add_argument("--timings", action="store_true",
                   help="one card: also time each step's compile from the "
                        "persistent cache and print the per-phase tables")
    args = p.parse_args(argv)

    from pbf_sph_tpu.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    import jax

    devs = require_gpu(args.cards)
    log(f"jax {jax.__version__} devices: {jax.devices()}")
    log("nvidia-smi name, power.limit:")
    log(card_name_and_power())
    log(f"compile cache: {cache}")

    t = args.timings
    if args.cards == 4:
        phases = [("sharded engines", lambda: phase_multicard(devs))]
    else:
        phases = [
            ("parity", phase_parity),
            ("dam1m", lambda: phase_full_size("dam1m", 10, 20, t)),
            ("mc128k", lambda: phase_full_size("mc128k", 5, 5, t)),
        ]
        if t:
            phases += [("dam1m phases", lambda: phase_timings("dam1m")),
                       ("mc128k phases", lambda: phase_timings("mc128k"))]
        phases.append(("cli", phase_cli))
    for name, fn in phases:
        t0 = time.perf_counter()
        log(f"== phase {name}")
        fn()
        log(f"== phase {name}: ok ({time.perf_counter() - t0:.3f} s)")

    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
