"""End-to-end CLI runs (small particle counts, CPU)."""

import numpy as np
import pytest

from pbf_sph_tpu import cli


def test_cli_list(capsys):
    assert cli.main(["--list"]) == 0
    out = capsys.readouterr().out
    assert "[0]" in out


def test_cli_numpy_backend(tmp_path, capsys):
    rc = cli.main([
        "--impl", "numpy", "--count", "1500", "--iter", "2", "--warmup", "1",
        "--no-surface", "--output", str(tmp_path / "o_{impl}_{type}_{iter}"),
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Benchmark completed after 2 frames" in out
    assert "Framerate" in out
    assert (tmp_path / "o_numpy_float_2" / "cloud.ply").exists()


@pytest.mark.slow
def test_cli_jax_backend_with_surface(capsys, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the CLI always saves (reference behaviour)
    rc = cli.main(["--impl", "jax", "--count", "1200", "--iter", "1", "--warmup", "0"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Final Vertex count" in out
    # surface on by default for the bench workload -> nonzero vertex count
    n = int(out.split("Final Vertex count   :")[1].splitlines()[0])
    assert n > 0


def test_cli_multichip_too_few_devices_fails(capsys, monkeypatch):
    """With fewer devices than asked, --multichip fails; it never re-execs
    onto another platform."""
    import subprocess

    def no_subprocess(*a, **k):
        raise AssertionError("cli started a subprocess")

    monkeypatch.setattr(subprocess, "call", no_subprocess)
    monkeypatch.setattr(subprocess, "run", no_subprocess)
    monkeypatch.setattr(subprocess, "Popen", no_subprocess)
    rc = cli.main(["--multichip", "16", "--impl", "jax", "--count", "900",
                   "--iter", "1", "--warmup", "0", "--no-surface"])
    assert rc != 0
    assert "needs 16 devices" in capsys.readouterr().err


def test_cli_output_templating():
    assert cli.rendered_output_name("x_{impl}_{type}_{iter}", "jax", False, 7) == "x_jax_float_7"
    assert cli.rendered_output_name("x_{impl}_{type}_{iter}", "cpp", True, 3) == "x_cpp_double_3"


@pytest.mark.slow
def test_visualise_live_parameter_mutation(tmp_path, capsys):
    """Live per-frame parameter mutation (reference GUI sliders,
    `src/visualise.cpp:89-94,119-141`): iteration, scale, and MC resolution
    change MID-RUN; static-shape changes recompile via the per-spec step
    cache and the run keeps going."""
    from pbf_sph_tpu import visualise

    rc = visualise.main([
        "--impl", "jax", "--particles", "600", "--frames", "5",
        "--out", str(tmp_path), "--every", "2", "--solver-iter", "2",
        "--set", "2:iteration=1",
        "--set", "3:surface=0",
        "--set", "4:force=0,12,0",
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert "set iteration=1" in out
    assert "set surface=0" in out
    # meshes exported while the surface was on (frames 0, 2), none at 4
    assert (tmp_path / "mesh_00002.obj").exists()
    assert not (tmp_path / "mesh_00004.obj").exists()
    assert (tmp_path / "cloud_00004.ply").exists()


def test_apply_live_set_units():
    from pbf_sph_tpu.core.configs import dam_break
    from pbf_sph_tpu.visualise import apply_live_set, parse_live_sets

    _, cfg, _ = dam_break(100, surface=True)
    c = apply_live_set(cfg, "iteration", "5")
    assert c.iteration == 5
    c = apply_live_set(cfg, "mc_isolevel", "42.5")
    assert c.surface.isolevel == 42.5
    c = apply_live_set(cfg, "surface", "0")
    assert c.surface is None
    c2 = apply_live_set(c, "surface", "1")
    assert c2.surface is not None
    c = apply_live_set(cfg, "force", "1,2,3")
    assert c.constant_force == (1.0, 2.0, 3.0)
    sets = parse_live_sets(["3:iteration=2", "3:scale=450", "7:dt=0.01"])
    assert sets == {3: [("iteration", "2"), ("scale", "450")], 7: [("dt", "0.01")]}


def test_precompile_plan_enumeration():
    """precompile_plan walks the scheduled --set mutations and dedups on the
    static-spec fields (iteration/scale/bounds/surface); dt/force changes are
    dynamic and must not add specs; ladder rungs double/halve mc_resolution."""
    from pbf_sph_tpu.core.configs import dam_break
    from pbf_sph_tpu.visualise import parse_live_sets, precompile_plan

    _, cfg, _ = dam_break(100, surface=True)
    sets = parse_live_sets([
        "2:iteration=1", "3:dt=0.02", "4:force=0,1,0", "5:iteration=1",
    ])
    plan = precompile_plan(cfg, sets)
    # only ONE distinct future spec (iteration=1); dt/force are dynamic
    assert [c.iteration for c in plan] == [1]

    plan = precompile_plan(cfg, {}, ladder=1)
    res = sorted(c.surface.resolution for c in plan)
    assert res == sorted([cfg.surface.resolution * 2, cfg.surface.resolution / 2])

    # surface off mid-run: the surfaceless spec is enumerated, no rungs on it
    sets = parse_live_sets(["1:surface=0"])
    plan = precompile_plan(cfg, sets, ladder=1)
    assert any(c.surface is None for c in plan)


def test_solver_warm_compiles_spec(tmp_path):
    """JaxSolver.warm AOT-compiles the step for a future config against
    abstract shapes only (the GUI-slider mitigation): the spec lands in the
    per-spec step cache and a subsequent advance() with that config runs."""
    import numpy as np

    from pbf_sph_tpu.core.configs import dam_break
    from pbf_sph_tpu.core.types import Scene
    from pbf_sph_tpu.models import make_solver

    _, cfg, xs = dam_break(200, surface=True)
    solver = make_solver("jax", h=cfg.h)
    future = cfg.replace(iteration=cfg.iteration + 1)
    spec = solver.warm(future, Scene(), len(xs))
    assert spec in solver._steps
    assert spec.iteration == future.iteration
    result, xs2 = solver.advance(future, Scene(), xs)
    assert len(xs2) == len(xs)
    assert np.isfinite(np.asarray(xs2.position)).all()


@pytest.mark.slow
def test_cli_multichip_recovery_replays_from_checkpoint(tmp_path, capsys,
                                                        monkeypatch):
    """Forced-overflow recovery: a hard drop injected
    mid-window must grow the capacity and resume from the LAST state
    snapshot, replaying only the frames after it — not the whole window."""
    from pbf_sph_tpu.parallel import sharded

    monkeypatch.chdir(tmp_path)
    orig_build = sharded.build_sharded_step
    attempt = {"n": 0}

    def patched_build(spec, mesh):
        step = orig_build(spec, mesh)
        this_attempt = attempt["n"]
        attempt["n"] += 1
        frame = {"f": 0}

        def wrapped(state, dyn, scn=None, bounds=None):
            out = step(state, dyn, scn=scn, bounds=bounds)
            f = frame["f"]
            frame["f"] += 1
            if this_attempt == 0 and f == 7:
                # inject a ghost drop at global frame 7 (after the frame-4
                # snapshot) — the physics itself never overflows at this size
                if spec.rebalance:
                    st, stats, b = out
                else:
                    st, stats = out
                stats = dict(stats)
                stats["ghost_dropped"] = np.ones_like(
                    np.asarray(stats["ghost_dropped"]))
                out = (st, stats, b) if spec.rebalance else (st, stats)
            return out

        return wrapped

    monkeypatch.setattr(sharded, "build_sharded_step", patched_build)
    rc = cli.main([
        "--multichip", "2", "--impl", "jax", "--count", "900",
        "--iter", "6", "--warmup", "6", "--no-surface", "--ckpt-every", "4",
        "--output", str(tmp_path / "mc_{impl}_{type}_{iter}"),
    ])
    captured = capsys.readouterr()
    assert rc == 0, captured.err
    # exactly one recovery, resumed from the frame-4 snapshot: frames 4..7
    # replayed (4 of 12), NOT the whole 12-frame window
    assert attempt["n"] == 2
    assert "resuming from the frame-4 snapshot" in captured.err
    assert "(4 of 12 frames replayed)" in captured.err
    assert "(resuming at frame 4/12)" in captured.out
    assert "Benchmark completed after 6 frames" in captured.out
    # conservation: every particle the workload built survives the recovery
    # (--count 900 -> two cubes of 343 = 686 actual particles)
    built = int(captured.out.split("Workload bench20k: ")[1].split()[0])
    final = int(captured.out.split("Final Particle count :")[1].splitlines()[0])
    assert final == built > 0


def test_visualise_live_stdin_loop(tmp_path, capsys, monkeypatch):
    """--live: key=value lines from stdin mutate the next frame; 'reset'
    restores the initial parameters; 'quit' ends the run early (the
    reference GUI's sliders + Reset button, src/visualise.cpp:119-141)."""
    import io

    from pbf_sph_tpu import visualise

    # all lines are drained before frame 1 runs (the reader thread is
    # joined-by-queue); quit must end the run well before --frames
    monkeypatch.setattr("sys.stdin", io.StringIO(
        "iteration=2\nbogus_line\nreset\nquit\n"))
    rc = visualise.main([
        "--impl", "numpy", "--particles", "300", "--frames", "50",
        "--no-surface", "--live", "--out", str(tmp_path),
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert "set iteration=2" in out
    assert "reset" in out
    assert "quit" in out
    # ended early: far fewer than 50 frames ran
    assert out.count("particles=") < 10


@pytest.mark.slow
def test_cli_multichip2d_rebalance(tmp_path, capsys, monkeypatch):
    """--multichip NXxNY --rebalance: the 2D tile runner threads the dynamic
    tensor-product cuts through the recovery loop and completes with full
    conservation (solver-only keeps the CPU compile small; the 2D
    surface path is certified by tests/test_sharded.py and dryrun phase 3)."""
    monkeypatch.chdir(tmp_path)
    rc = cli.main([
        "--multichip", "2x2", "--rebalance", "--impl", "jax",
        "--count", "900", "--iter", "2", "--warmup", "1", "--no-surface",
        "--output", str(tmp_path / "mc2d_{impl}_{type}_{iter}"),
    ])
    captured = capsys.readouterr()
    assert rc == 0, captured.err
    assert "Multichip 2D: 2x2 tiles" in captured.out
    assert "rebalancing cuts" in captured.out
    assert "Benchmark completed after 2 frames" in captured.out
    built = int(captured.out.split("Workload bench20k: ")[1].split()[0])
    final = int(captured.out.split("Final Particle count :")[1].splitlines()[0])
    assert final == built > 0
