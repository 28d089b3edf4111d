"""Benchmark CLI — the headless entry point.

Mirrors the reference driver's flags and output (reference `src/args.hpp:38-56`,
`src/args.cpp:7-75`, `src/benchmark.cpp:77-175`):
  --impl {jax,cpp,numpy}   (reference: {omp,ocl,sycl,sycl2020})
  --list --verbose --devices --iter --warmup --fp64 --output
plus new workload/scale selection (--workload) and working --output export
(PLY cloud + OBJ mesh — the reference documented but never implemented this,
`src/sph.hpp:188-196`).

Default workload is the reference benchmark: 20k particles (two cubes),
6 constraint iterations, scale 500, surface on, oscillating bounds, 200 warmup
+ 200 timed frames (reference `src/benchmark.cpp:23-29,78`).
"""

from __future__ import annotations

import argparse
import math
import sys
import time
from typing import List

import numpy as np

from pbf_sph_tpu.core.configs import WORKLOADS
from pbf_sph_tpu.core.scene import apply_motion_sin_x_cos_z
from pbf_sph_tpu.core.types import Scene
from pbf_sph_tpu.models import BACKENDS, make_solver
from pbf_sph_tpu.utils.stopwatch import Stopwatch

DEFAULT_ITER = 200
DEFAULT_WARMUP = 200


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pbf-sph-tpu",
        description="PBF-SPH benchmark (same workload as the reference mini-app)",
    )
    p.add_argument("--impl", choices=BACKENDS, default="jax",
                   help="solver backend (default jax)")
    p.add_argument("--list", action="store_true", help="list available devices and exit")
    p.add_argument("--verbose", action="store_true", help="enable verbose device output")
    p.add_argument("--devices", action="append", default=[],
                   help="device index or name substring (repeatable)")
    p.add_argument("--iter", type=int, default=DEFAULT_ITER, dest="iterations",
                   help="timed frames (default 200)")
    p.add_argument("--warmup", type=int, default=DEFAULT_WARMUP,
                   help="warmup frames (default 200)")
    p.add_argument("--fp64", action="store_true", help="use fp64 (jax/numpy backends)")
    p.add_argument("--output", default="",
                   help="output dir template, expands {impl} {type} {iter}")
    p.add_argument("--workload", default="bench20k", choices=sorted(WORKLOADS),
                   help="workload preset (default: the reference benchmark)")
    p.add_argument("--count", type=int, default=0,
                   help="override the workload's particle count")
    p.add_argument("--no-surface", action="store_true", help="disable marching cubes")
    p.add_argument("--phase-timings", action="store_true",
                   help="print the per-frame Stopwatch phase table")
    p.add_argument("--multichip", default="", metavar="N|NXxNY",
                   help="run the workload across N devices (x-slab domain "
                        "decomposition + ppermute halo exchange) or an NXxNY "
                        "2D tile mesh (e.g. 2x2 — two-phase halo exchange "
                        "incl. tile-local marching cubes).  Fails when fewer "
                        "devices exist")
    p.add_argument("--rebalance", action="store_true",
                   help="dynamic equal-count re-partitioning from the "
                        "particle CDF (multichip: slab widths in 1D, "
                        "tensor-product cuts per axis in 2D)")
    p.add_argument("--ckpt-every", type=int, default=50, metavar="K",
                   help="multichip: snapshot the state every K frames so a "
                        "capacity recovery replays only the frames after the "
                        "last snapshot instead of the whole window (default 50)")
    return p


def list_devices(verbose: bool) -> None:
    try:
        import jax

        for i, d in enumerate(jax.devices()):
            print(f"[{i}] {d.platform}:{d.device_kind}")
            if verbose:
                print(f"    {d}")
    except Exception as e:  # pragma: no cover
        print(f"[0] cpu (jax unavailable: {e})")


def find_device(specs: List[str], verbose: bool = False):
    """Select a jax device by index or name substring (reference
    `src/utils.hpp:128-159`: try index first, then case-insensitive substring
    over the enumerated names; on no match, print the device list and fail)."""
    import jax

    devs = jax.devices()
    for spec in specs:
        s = spec.strip()
        if s.isdigit():
            # purely an index: an out-of-range index fails instead of falling
            # through to substring matching (where it could accidentally match
            # a digit inside a device repr, e.g. coords "(3,0,0)")
            if int(s) < len(devs):
                return devs[int(s)]
            continue
        for d in devs:
            name = f"{d.platform}:{d.device_kind} {d}"
            if s.lower() in name.lower():
                return d
    list_devices(verbose)
    raise SystemExit(f"No device matched {specs!r} (available devices listed above)")


def rendered_output_name(template: str, impl: str, fp64: bool, iterations: int) -> str:
    """Output-name templating (reference `src/args.cpp:69-75`)."""
    t = "double" if fp64 else "float"
    return (
        template.replace("{impl}", impl)
        .replace("{type}", t)
        .replace("{iter}", str(iterations))
    )


def run_multichip(args, config, particles, output) -> int:
    """Benchmark the workload over an N-device mesh (the sharded engine as a
    product path, not just a library one)."""
    if "x" in str(args.multichip).lower():
        nx2d, ny2d = (int(v) for v in str(args.multichip).lower().split("x"))
        n_dev = nx2d * ny2d
    else:
        nx2d = ny2d = 0
        n_dev = int(args.multichip)
    import jax

    have = len(jax.devices())
    if have < n_dev:
        print(f"--multichip {args.multichip} needs {n_dev} devices, "
              f"{jax.default_backend()} has {have}", file=sys.stderr)
        return 1

    import numpy as np
    from jax.sharding import Mesh

    from pbf_sph_tpu.core.scene import apply_motion_sin_x_cos_z
    from pbf_sph_tpu.core.types import ColouredMesh, Result
    from pbf_sph_tpu.models.jax_solver import dyn_params_of
    from pbf_sph_tpu.parallel import sharded

    import dataclasses as _dc

    if nx2d:
        return run_multichip2d(args, config, particles, output, nx2d, ny2d)

    mesh = Mesh(np.array(jax.devices()[:n_dev]), (sharded.AXIS,))
    cap_local = 0
    ghost_cap = 0
    migrate_cap = None
    surface_over = {}

    def build_spec():
        spec = sharded.ShardSpec.create(
            config, n_dev, len(particles), config.h,
            rebalance=args.rebalance, cap_local=cap_local,
            ghost_cap=ghost_cap,
        )
        if migrate_cap is not None:
            spec = _dc.replace(
                spec, migrate_cap=min(int(migrate_cap), spec.cap_local))
        if surface_over and spec.surface is not None:
            spec = _dc.replace(
                spec, surface=_dc.replace(spec.surface, **surface_over))
        return spec

    # capacity recovery loop: dropped work in ANY frame corrupts the physics,
    # so the run RESUMES from the last good state snapshot under a spec
    # grown from the observed demand — replaying only the frames after the
    # snapshot, not the whole window.  Deferral (migrate_deferred) is
    # self-recovering (the particle is retained and retried next frame), so
    # it triggers a re-run only when the backlog fails to drain by the end
    # of the window; drops/overflows remain hard per-frame triggers.
    HARD_KEYS = ("migrate_dropped", "ghost_dropped", "mc_emit_overflow")
    DROP_KEYS = HARD_KEYS + ("migrate_deferred",)
    warm = args.warmup
    total_frames = warm + args.iterations
    ckpt_every = max(1, args.ckpt_every)

    # snapshot = state BEFORE global frame ckpt_frame
    ckpt_frame = 0
    ckpt_soa = particles
    ckpt_bounds = None
    frame_times: List[float] = []
    stats = None
    replays = 0

    for attempt in range(8):
        spec = build_spec()
        if args.rebalance:
            bounds = (np.asarray(ckpt_bounds, np.int32)
                      if ckpt_bounds is not None
                      else spec.initial_bounds(ckpt_soa))
        else:
            bounds = None
        state = sharded.shard_state(
            sharded.distribute_particles(ckpt_soa, spec, bounds=bounds), mesh
        )
        step = sharded.build_sharded_step(spec, mesh)
        print(f"Multichip: {n_dev} devices ({jax.devices()[0].platform}), "
              f"{'rebalancing' if args.rebalance else 'fixed'} x-slabs, "
              f"cap_local={spec.cap_local}"
              + (f" (resuming at frame {ckpt_frame}/{total_frames})"
                 if ckpt_frame else ""))

        def one(g, state, bounds):
            # motion phase: warmup counts 0..warm-1, the timed loop restarts
            # at 0 (reference `src/benchmark.cpp:43-47`)
            frame = g if g < warm else g - warm
            dyn = dyn_params_of(
                apply_motion_sin_x_cos_z(config, frame), np.float32)
            if spec.rebalance:
                state, stats, bounds = step(state, dyn, bounds=bounds)
            else:
                state, stats = step(state, dyn)
            return state, stats, bounds

        totals = {k: 0 for k in DROP_KEYS}
        ghost_peak = 0
        tri_peak = 0
        occ_need = 0         # per-device demand: alive + refused immigrants
        deferred_last = 0
        extent_bad = False
        hard_fail = False

        def track(stats):
            # np.asarray forces the frame to complete (host sync)
            nonlocal ghost_peak, tri_peak, occ_need, deferred_last, extent_bad
            frame_hard = False
            for k in DROP_KEYS:
                if k in stats:
                    v = int(np.asarray(stats[k]).sum())
                    totals[k] += v
                    if v and k in HARD_KEYS:
                        frame_hard = True
            deferred_last = int(np.asarray(stats["migrate_deferred"]).sum())
            ghost_peak = max(ghost_peak, int(np.asarray(stats["ghost_peak"]).max()))
            alive_d = np.asarray(stats["alive_count"]).ravel()
            drop_d = np.asarray(stats["migrate_dropped"]).ravel()
            occ_need = max(occ_need, int((alive_d + drop_d).max()))
            if spec.surface is not None:
                tri_peak = max(tri_peak, int(np.asarray(stats["tri_count"]).max()))
            extent_bad |= not np.asarray(stats["extent_ok"]).all()
            return frame_hard

        # replay: timed-frame stats measured beyond the snapshot are invalid
        del frame_times[max(ckpt_frame - warm, 0):]
        g = ckpt_frame
        while g < total_frames:
            t0 = time.perf_counter()
            state, stats, bounds = one(g, state, bounds)
            frame_hard = track(stats)
            if g >= warm:
                frame_times.append((time.perf_counter() - t0) * 1000.0)
            if frame_hard or extent_bad:
                hard_fail = True
                break
            g += 1
            if g % ckpt_every == 0 and g < total_frames:
                ckpt_soa = state.to_soa()
                ckpt_bounds = (np.asarray(bounds) if bounds is not None
                               else None)
                ckpt_frame = g

        if extent_bad:
            # not a capacity: the dynamic bounds outgrew the compiled global
            # grid (the spec freezes the extent from the initial bounds)
            print("ERROR: dynamic bounds outgrew the compiled grid extent "
                  "(extent_ok=0) — results are not trustworthy; rebuild for "
                  "the larger domain", file=sys.stderr)
            return 1
        grown = False
        if totals["ghost_dropped"] > 0:
            ghost_cap = -(-max(int(ghost_peak * 1.25), spec.ghost_cap + 128) // 128) * 128
            grown = True
        if totals["migrate_dropped"] > 0:
            # grow from the observed demand (peak per-device occupancy plus
            # the refused immigrants), not a blind factor
            cap_local = -(-max(int(occ_need * 5 // 4), spec.cap_local + 128) // 128) * 128
            grown = True
        if totals["migrate_deferred"] > 0 and deferred_last > 0:
            # a backlog that failed to drain by the final frame; transient
            # mid-window deferrals self-recover and are only reported
            migrate_cap = -(-(spec.migrate_cap + deferred_last) * 5 // 4 // 128) * 128
            grown = True
        if spec.surface is not None:
            if totals["mc_emit_overflow"] > 0 and spec.surface.cube_cap > 0:
                vol = int(np.prod([s - 1 for s in spec.surface.sample]))
                surface_over["cube_cap"] = min(
                    -(-(spec.surface.cube_cap + totals["mc_emit_overflow"]) * 5 // 4 // 128) * 128,
                    vol)
                grown = True
            if tri_peak > spec.surface.tri_capacity:
                surface_over["tri_capacity"] = -(-int(tri_peak * 3 // 2) // 1024) * 1024
                grown = True
        if not grown and not hard_fail:
            if totals["migrate_deferred"] > 0:
                print(f"# note: {totals['migrate_deferred']} transient "
                      f"migration deferrals (drained by the final frame; "
                      f"peak backlog is self-recovering)", file=sys.stderr)
            break
        if not grown:
            raise RuntimeError(
                f"hard failure at frame {g} without a growable capacity: "
                f"{totals}")
        replays += 1
        cap_local = max(cap_local, ghost_cap, spec.cap_local)
        print(f"# dropped/deferred work {totals} at frame {g} "
              f"(ghost_peak={ghost_peak}, occ_need={occ_need}, "
              f"tri_peak={tri_peak}) — growing capacities and resuming from "
              f"the frame-{ckpt_frame} snapshot "
              f"({g - ckpt_frame + 1} of {total_frames} frames replayed)",
              file=sys.stderr)
    else:
        raise RuntimeError(
            f"multichip capacity growth did not converge: {totals}")
    elapsed = sum(frame_times) / 1000.0

    lo, hi, mean, _, std = summary_stats(frame_times)
    counts = np.asarray(stats["alive_count"]).ravel()
    tri_total = (
        int(np.asarray(stats["tri_count"]).sum()) if spec.surface is not None else 0
    )
    print(
        f"Benchmark completed after {args.iterations} frames:\n"
        f"Runtime              : {elapsed:.4g} s\n"
        f"Framerate            : {args.iterations / elapsed:.4g} fps\n"
        f"Frame-time min       : {lo:.4g} ms\n"
        f"Frame-time max       : {hi:.4g} ms\n"
        f"Frame-time mean       : {mean:.4g} ms\n"
        f"Frame-time stdDev     : {std:.4g} ms\n"
        f"Final Vertex count   : {tri_total * 3}\n"
        f"Final Particle count : {int(counts.sum())} \n"
        f"Per-device particles : {counts.tolist()}"
    )
    xs = state.to_soa()
    if spec.surface is not None:
        vs, ns, cs = sharded.gather_mesh(stats, spec)
        result = Result(mesh=ColouredMesh(vs=vs, ns=ns, cs=cs))
    else:
        result = Result()
    from pbf_sph_tpu.utils.export import save

    save(result, xs, output)
    print("Results flushed.")
    return 0


def run_multichip2d(args, config, particles, output, nx: int, ny: int) -> int:
    """Benchmark over an NXxNY 2D tile mesh (parallel/sharded2d.py) with the
    same snapshot-bounded capacity recovery as the 1D runner; supports
    --rebalance (dynamic tensor-product cuts) and surface workloads
    (tile-local marching cubes)."""
    import dataclasses as _dc

    import jax
    import numpy as np

    from pbf_sph_tpu.core.scene import apply_motion_sin_x_cos_z
    from pbf_sph_tpu.core.types import ColouredMesh, Result
    from pbf_sph_tpu.models.jax_solver import dyn_params_of
    from pbf_sph_tpu.parallel import sharded2d

    cap_local = 0
    overrides = {}
    surface_over = {}
    HARD_KEYS = ("migrate_dropped", "ghost_dropped", "mc_emit_overflow")
    warm = args.warmup
    total_frames = warm + args.iterations
    ckpt_every = max(1, args.ckpt_every)

    ckpt_frame = 0
    ckpt_soa = particles
    ckpt_bounds = None
    frame_times: List[float] = []
    stats = None

    for attempt in range(8):
        spec = sharded2d.Shard2DSpec.create(
            config, nx, ny, ckpt_soa, config.h,
            cap_local=cap_local, rebalance=args.rebalance)
        if overrides:
            spec = _dc.replace(spec, **overrides)
        if surface_over and spec.surface is not None:
            spec = _dc.replace(
                spec, surface=_dc.replace(spec.surface, **surface_over))
        if args.rebalance:
            bounds = (ckpt_bounds if ckpt_bounds is not None else
                      (np.asarray(spec.xb, np.int32),
                       np.asarray(spec.yb, np.int32)))
        else:
            bounds = None
        mesh = sharded2d.make_mesh2d(nx, ny)
        state = sharded2d.shard_state_2d(
            sharded2d.distribute_particles_2d(ckpt_soa, spec, bounds=bounds),
            mesh)
        step = sharded2d.build_sharded2d_step(spec, mesh)
        # print the cuts the run actually uses (a rebalance-mode resume
        # restores the dynamic cuts from the snapshot, not the fresh spec's)
        xb_used = (tuple(int(v) for v in bounds[0]) if bounds is not None
                   else spec.xb)
        yb_used = (tuple(int(v) for v in bounds[1]) if bounds is not None
                   else spec.yb)
        print(f"Multichip 2D: {nx}x{ny} tiles ({jax.devices()[0].platform}), "
              f"{'rebalancing' if args.rebalance else 'static'} cuts, "
              f"cap_local={spec.cap_local}, xb={xb_used}, yb={yb_used}"
              + (f" (resuming at frame {ckpt_frame}/{total_frames})"
                 if ckpt_frame else ""))

        totals = dict(migrate_dropped=0, ghost_dropped=0, migrate_deferred=0,
                      mc_emit_overflow=0)
        ghost_peak = 0
        tri_peak = 0
        occ_need = 0
        deferred_last = 0
        extent_bad = False
        hard_fail = False

        def track(st):
            nonlocal ghost_peak, tri_peak, occ_need, deferred_last, extent_bad
            hard = False
            for k in totals:
                if k not in st:
                    continue
                v = int(np.asarray(st[k]).sum())
                totals[k] += v
                if v and k in HARD_KEYS:
                    hard = True
            deferred_last = int(np.asarray(st["migrate_deferred"]).sum())
            ghost_peak = max(ghost_peak, int(np.asarray(st["ghost_peak"]).max()))
            alive_d = np.asarray(st["alive_count"]).ravel()
            drop_d = np.asarray(st["migrate_dropped"]).ravel()
            occ_need = max(occ_need, int((alive_d + drop_d).max()))
            if spec.surface is not None:
                tri_peak = max(tri_peak, int(np.asarray(st["tri_count"]).max()))
            extent_bad |= not np.asarray(st["extent_ok"]).all()
            return hard

        del frame_times[max(ckpt_frame - warm, 0):]
        g = ckpt_frame
        while g < total_frames:
            frame = g if g < warm else g - warm
            dyn = dyn_params_of(
                apply_motion_sin_x_cos_z(config, frame), np.float32)
            t0 = time.perf_counter()
            if spec.rebalance:
                state, stats, bounds = step(state, dyn, bounds=bounds)
            else:
                state, stats = step(state, dyn)
            hard = track(stats)
            if g >= warm:
                frame_times.append((time.perf_counter() - t0) * 1000.0)
            if hard or extent_bad:
                hard_fail = True
                break
            g += 1
            if g % ckpt_every == 0 and g < total_frames:
                ckpt_soa = state.to_soa()
                ckpt_bounds = (
                    (np.asarray(bounds[0]), np.asarray(bounds[1]))
                    if bounds is not None else None)
                ckpt_frame = g

        if extent_bad:
            print("ERROR: dynamic bounds outgrew the compiled grid extent",
                  file=sys.stderr)
            return 1
        grown = False
        if totals["ghost_dropped"] > 0:
            gcap = -(-max(int(ghost_peak * 1.25), 128) // 128) * 128
            overrides["ghost_x"] = max(gcap, spec.ghost_x + 128)
            overrides["ghost_y"] = max(gcap, spec.ghost_y + 128)
            grown = True
        if totals["migrate_dropped"] > 0:
            cap_local = -(-max(int(occ_need * 5 // 4), spec.cap_local + 128) // 128) * 128
            grown = True
        if totals["migrate_deferred"] > 0 and deferred_last > 0:
            overrides["migrate_cap"] = -(-(spec.migrate_cap + deferred_last) * 5 // 4 // 128) * 128
            grown = True
        if spec.surface is not None:
            if totals["mc_emit_overflow"] > 0 and spec.surface.cube_cap > 0:
                vol = int(np.prod([s - 1 for s in spec.surface.sample]))
                surface_over["cube_cap"] = min(
                    -(-(spec.surface.cube_cap + totals["mc_emit_overflow"]) * 5 // 4 // 128) * 128,
                    vol)
                grown = True
            if tri_peak > spec.surface.tri_capacity:
                surface_over["tri_capacity"] = -(-int(tri_peak * 3 // 2) // 1024) * 1024
                grown = True
        if not grown and not hard_fail:
            if totals["migrate_deferred"] > 0:
                print(f"# note: {totals['migrate_deferred']} transient "
                      f"migration deferrals (drained)", file=sys.stderr)
            break
        if not grown:
            raise RuntimeError(f"hard failure without growable capacity: {totals}")
        print(f"# dropped work {totals} at frame {g} (ghost_peak={ghost_peak},"
              f" occ_need={occ_need}, tri_peak={tri_peak}) — growing and "
              f"resuming from the frame-{ckpt_frame} snapshot "
              f"({g - ckpt_frame + 1} of {total_frames} frames replayed)",
              file=sys.stderr)
    else:
        raise RuntimeError(f"2D capacity growth did not converge: {totals}")

    elapsed = sum(frame_times) / 1000.0
    lo, hi, mean, _, std = summary_stats(frame_times)
    counts = np.asarray(stats["alive_count"]).ravel()
    tri_total = (
        int(np.asarray(stats["tri_count"]).sum())
        if spec.surface is not None else 0)
    print(
        f"Benchmark completed after {args.iterations} frames:\n"
        f"Runtime              : {elapsed:.4g} s\n"
        f"Framerate            : {args.iterations / elapsed:.4g} fps\n"
        f"Frame-time min       : {lo:.4g} ms\n"
        f"Frame-time max       : {hi:.4g} ms\n"
        f"Frame-time mean       : {mean:.4g} ms\n"
        f"Frame-time stdDev     : {std:.4g} ms\n"
        f"Final Vertex count   : {tri_total * 3}\n"
        f"Final Particle count : {int(counts.sum())} \n"
        f"Per-tile particles   : {counts.tolist()}"
    )
    xs = state.to_soa()
    if spec.surface is not None:
        vs, ns, cs = sharded2d.gather_mesh(
            {k: np.asarray(v) for k, v in stats.items()}, spec)
        result = Result(mesh=ColouredMesh(vs=vs, ns=ns, cs=cs))
    else:
        result = Result()
    from pbf_sph_tpu.utils.export import save

    save(result, xs, output)
    print("Results flushed.")
    return 0


def summary_stats(xs: List[float]):
    a = np.asarray(xs, np.float64)
    mean = a.mean()
    var = ((a - mean) ** 2).mean()  # population variance (reference benchmark.cpp:68-70)
    return a.min(), a.max(), mean, var, math.sqrt(var)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from pbf_sph_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if args.list:
        list_devices(args.verbose)
        return 0

    # every backend honours --fp64 (cpp via the pbf_advance_f64 entry,
    # reference benchmark.cpp:159-165)
    dtype = "float64" if args.fp64 else "float32"

    if args.devices and args.impl == "jax":
        import jax

        dev = find_device(args.devices, args.verbose)
        print(f"Using device: {dev}")
        jax.config.update("jax_default_device", dev)

    kwargs = {"dtype": dtype}
    if args.fp64:
        import jax

        jax.config.update("jax_enable_x64", True)

    if args.count and args.workload.startswith("bench"):
        from pbf_sph_tpu.core.scene import simple_config_with_2_cubes

        mc, config, particles = simple_config_with_2_cubes(args.count, 6, 500.0)
    elif args.count:
        from pbf_sph_tpu.core.configs import dam_break

        mc, config, particles = dam_break(args.count)
    else:
        mc, config, particles = WORKLOADS[args.workload]()
    if config.surface is None and not args.no_surface and args.workload.startswith("bench"):
        config = config.replace(surface=mc)
    if args.no_surface:
        config = config.replace(surface=None)

    output = rendered_output_name(args.output or "./out_{impl}_{type}_{iter}",
                                  args.impl, args.fp64, args.iterations)
    if args.multichip:
        if args.impl != "jax":
            print("--multichip requires --impl jax", file=sys.stderr)
            return 1
        if args.fp64:
            print("--multichip is fp32-only", file=sys.stderr)
            return 1
        print(f"Using {output} for output")
        print(f"Workload {args.workload}: {len(particles)} particles, "
              f"{config.iteration} iterations, "
              f"surface={'on' if config.surface else 'off'}")
        return run_multichip(args, config, particles, output)

    solver = make_solver(args.impl, h=config.h, **kwargs)
    print(f"Using {output} for output")
    print(f"Workload {args.workload}: {len(particles)} particles, "
          f"{config.iteration} iterations, surface={'on' if config.surface else 'off'}")

    xs = particles
    result = None
    for frame in range(args.warmup):
        try:
            result, xs = solver.advance(apply_motion_sin_x_cos_z(config, frame), Scene(), xs)
        except Exception as e:  # reference surfaces the frame index (benchmark.cpp:34-36)
            print(f"Caught exception at warmup frame {frame}:\n{e}")
            raise

    frame_times = []
    start = time.perf_counter()
    # the reference restarts the bound-motion phase for the timed loop
    # (frame index resets to 0, `src/benchmark.cpp:43-47`)
    for frame in range(args.iterations):
        watch = Stopwatch("advance")
        f_start = time.perf_counter()
        stop = watch.start("advance")
        try:
            cfg_f = apply_motion_sin_x_cos_z(config, frame)
            if args.phase_timings and args.impl == "jax" and config.wait:
                from pbf_sph_tpu.models.timed import advance_timed

                result, xs, watch = advance_timed(solver, cfg_f, Scene(), xs)
            else:
                result, xs = solver.advance(cfg_f, Scene(), xs)
                if args.phase_timings and getattr(solver, "last_watch", None):
                    # oracle backends time phases natively (the reference OMP
                    # backend prints its Stopwatch per frame,
                    # src/omp/ompsph.hpp:482)
                    watch = solver.last_watch
        except Exception as e:
            print(f"Caught exception at benchmark frame {frame}:\n{e}")
            raise
        stop()
        frame_times.append((time.perf_counter() - f_start) * 1000.0)
        if args.phase_timings:
            print(watch)
    elapsed = time.perf_counter() - start

    lo, hi, mean, _, std = summary_stats(frame_times)
    fps = args.iterations / elapsed
    print(
        f"Benchmark completed after {args.iterations} frames:\n"
        f"Runtime              : {elapsed:.4g} s\n"
        f"Framerate            : {fps:.4g} fps\n"
        f"Frame-time min       : {lo:.4g} ms\n"
        f"Frame-time max       : {hi:.4g} ms\n"
        f"Frame-time mean       : {mean:.4g} ms\n"
        f"Frame-time stdDev     : {std:.4g} ms\n"
        f"Final Vertex count   : {len(result.mesh.vs)}\n"
        f"Final Particle count : {len(xs)} \n"
    )
    # the reference always saves to the (templated) output dir
    # (`src/benchmark.cpp:102-103`)
    from pbf_sph_tpu.utils.export import save

    save(result, xs, output)
    print("Results flushed.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
