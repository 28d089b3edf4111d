#!/usr/bin/env python
"""Benchmark: prints ONE JSON line with the headline metric.

Metric: particle-steps/sec on the 1M-particle dam-break, 6 constraint
iterations, solver-only, single device.

Env overrides: PBF_BENCH_COUNT, PBF_BENCH_FRAMES, PBF_BENCH_WARMUP,
PBF_BENCH_IMPL, PBF_BENCH_ITERS, PBF_BENCH_WORKLOAD (a `core/configs.py`
preset name).
"""

import json
import os
import sys
import time


def main() -> int:
    count = int(os.environ.get("PBF_BENCH_COUNT", 1_000_000))
    frames = int(os.environ.get("PBF_BENCH_FRAMES", 30))
    warmup = int(os.environ.get("PBF_BENCH_WARMUP", 10))
    impl = os.environ.get("PBF_BENCH_IMPL", "jax")
    iters = int(os.environ.get("PBF_BENCH_ITERS", 6))
    workload = os.environ.get("PBF_BENCH_WORKLOAD", "")

    import jax

    from pbf_sph_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from pbf_sph_tpu.core.configs import WORKLOADS, dam_break
    from pbf_sph_tpu.core.types import Scene
    from pbf_sph_tpu.models import make_solver
    from pbf_sph_tpu.models.jax_solver import dyn_params_of

    if workload:
        mc, cfg, xs = WORKLOADS[workload]()
        iters = cfg.iteration
    else:
        mc, cfg, xs = dam_break(count, solver_iter=iters)
    solver = make_solver(impl, h=cfg.h)

    spec, state, scn = solver.prepare(cfg, Scene(), xs)
    dyn = dyn_params_of(cfg, solver.dtype)

    # compile + settle under grown capacities (models/growth.py)
    from pbf_sph_tpu.models.growth import settle

    spec, state = settle(solver, spec, state, dyn, scn, xs, warmup)

    t0 = time.perf_counter()
    outs = []
    for _ in range(frames):
        state, out = solver.step_device(spec, state, dyn, scn)
        outs.append(out["max_occupancy"])
    jax.block_until_ready(state)
    elapsed = time.perf_counter() - t0

    n = len(xs)
    steps_per_sec = frames / elapsed
    pps = n * steps_per_sec
    dev = jax.devices()[0]
    print(
        json.dumps(
            {
                "metric": f"particle-steps/sec (dam-break {n} particles, {iters} iters, {impl})",
                "value": round(pps, 1),
                "unit": "particle-steps/s",
                "device": {"platform": dev.platform, "kind": dev.device_kind,
                           "count": len(jax.devices())},
            }
        )
    )
    print(
        f"# {steps_per_sec:.2f} steps/s, {1000 * elapsed / frames:.2f} ms/step, "
        f"max occupancy {int(max(int(o) for o in outs))}, capacity K={spec.cell_capacity}",
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
