#!/usr/bin/env python3
"""Quickest proof that hpsolve runs on an NVIDIA GPU.

    python3 chip_smoke.py           # one card: the phases below
    python3 chip_smoke.py --four    # four cards: TeraShake split four ways

Phases, in one process (one process per card):

  device      jax.devices() and the card's name and power limit; fails
              unless the platform is "gpu" (there is no CPU fallback)
  main path   TeraShake at 0.1 Hz (~11.3M elements, graded octree)
              through hpsolve's entry (cli.run) on a copy of the
              committed inputs, for a few chunks; must take the brick
              path
  kernel      the fused element kernel against the plain XLA brick
              operator (f32 HIGHEST and f64) at the TeraShake bricks,
              and the whole brick step timed with and without it
  reference   TeraShake at 0.05 Hz: the f32 brick path against the f64
              unstructured solver (solver/step.py), same steps
  gpu tests   pytest -m gpu

--four runs only TeraShake at 0.1 Hz through Simulation.run(ndev=4)
and compares it with a one-card run of the same steps.

Everything is written under chiprun_out/chip_smoke/.  The last line of
standard output is the JSON result; any failure exits non-zero before it.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "chiprun_out", "chip_smoke")

MAIN_FREQ_HZ = 0.1
REF_FREQ_HZ = 0.05
END_S = 4.0                 # 200 steps at TeraShake's dt = 0.02 s
# f32 with HIGHEST products against f64 sits near 1e-5 after ~100-200
# steps; a TF32 product shows up near 1e-3
REF_TOL = 1e-4
# kernel vs plain operator, one application, relative to max |f|
KERNEL_TOL = 1e-5
# four cards (unstructured sharded f32) vs one card (brick f32)
FOUR_TOL = 1e-4
TIMED_STEPS = 50


def log(msg):
    print(msg, flush=True)


def card_info() -> str:
    """`name, power limit` of the card(s) as nvidia-smi reports them,
    one line per card."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, check=True)
    return r.stdout.strip()


def device_phase(n_cards):
    import jax
    devs = jax.devices()
    log(f"[device] jax.devices(): {devs}")
    if devs[0].platform != "gpu":
        raise RuntimeError(f"no GPU: JAX platform is {devs[0].platform}")
    if len(devs) < n_cards:
        raise RuntimeError(f"need {n_cards} cards, JAX sees {len(devs)}")
    card = card_info()
    log(card)
    return "; ".join(card.splitlines())


def rel_max_err(a, ref):
    import numpy as np
    a = np.asarray(a, np.float64)
    ref = np.asarray(ref, np.float64)
    scale = np.abs(ref).max()
    if not np.isfinite(a).all() or scale == 0:
        return float("inf")
    return float(np.abs(a - ref).max() / scale)


def peak_bytes():
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use", -1)


def main_path(out, freq_hz=MAIN_FREQ_HZ, end_s=END_S):
    """hpsolve on TeraShake at `freq_hz`; returns the Simulation."""
    from hercules_tpu import cli
    from hercules_tpu.tools.cases import prepare_terashake
    run = os.path.join(out, f"terashake_{freq_hz:g}hz")
    shutil.rmtree(run, ignore_errors=True)
    cvmdb, phys, num = prepare_terashake(run, freq_hz, end_s)
    t0 = time.perf_counter()
    rc, sim = cli.run(["--ndev=1", cvmdb, phys, num])
    wall = time.perf_counter() - t0
    if rc != 0 or sim is None:
        raise RuntimeError(f"hpsolve exited {rc}")
    if sim.solver_path_name != "bricks":
        raise RuntimeError(
            f"main path took {sim.solver_path_name!r}, not the brick path")
    log(f"[main path] TeraShake {freq_hz:g} Hz: {sim.mesh.lenum} elements, "
        f"{sim.mesh.nnum} nodes, {sim.params.total_steps} steps; "
        f"solver_path_name={sim.solver_path_name}; "
        f"mesh {sim.timings['mesh']:.1f} s, assemble "
        f"{sim.timings['assemble']:.1f} s, hpsolve wall {wall:.1f} s; "
        f"peak_bytes_in_use {peak_bytes()}")
    return sim


def _synced(x):
    import jax
    jax.block_until_ready(x)
    return x


def kernel_phase(sim, card, interpret=False, steps=TIMED_STEPS):
    """Kernel check at the Simulation's bricks, then the brick step timed
    with and without the kernel.  Returns (max rel err f64, f32)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from hercules_tpu.solver.brick_kernel import make_elastic_force
    from hercules_tpu.solver.bricks import build_plan
    from hercules_tpu.solver.brickstep import (assemble_brick_tables,
                                               init_brick_state,
                                               make_brick_step,
                                               plain_elastic_force)
    plan = build_plan(sim.mesh)
    t_host, meta, TOT = assemble_brick_tables(plan, sim.tables,
                                              src_ids=sim.src_ids)
    log(f"[kernel] {len(meta)} bricks, {len(plan.loose_eidx)} loose "
        f"elements, {TOT} brick nodes; bricks (nodes, elements, o7): "
        f"{[(m.nb, m.S, m.offs[7]) for m in meta]}")
    rng = np.random.default_rng(0)
    u = rng.standard_normal((3, TOT))
    up = u + 1e-2 * rng.standard_normal((3, TOT))

    def tables(dtype):
        return {"mcat": jnp.asarray(t_host["mcat"], dtype),
                **{k: jnp.asarray(t_host[k], dtype)
                   for k in ("c1", "c2", "c3", "c4")}}

    plain = jax.jit(lambda d, u, up: plain_elastic_force(d, u, up, meta,
                                                         TOT))
    d64 = tables(jnp.float64)
    ref = np.asarray(_synced(plain(d64, jnp.asarray(u, jnp.float64),
                                   jnp.asarray(up, jnp.float64))))
    d32 = tables(jnp.float32)
    u32, up32 = jnp.asarray(u, jnp.float32), jnp.asarray(up, jnp.float32)
    f_plain = np.asarray(_synced(plain(d32, u32, up32)))
    kforce, tab = make_elastic_force(meta, TOT, t_host["mcat"],
                                     jnp.float32, interpret=interpret)
    kf = jax.jit(kforce)
    args = (jnp.asarray(tab), u32, up32, d32["c1"], d32["c2"], d32["c3"],
            d32["c4"])
    t0 = time.perf_counter()
    comp = kf.lower(*args).compile()
    t_compile = time.perf_counter() - t0
    f_kern = np.asarray(_synced(comp(*args)))
    e64 = rel_max_err(f_kern, ref)
    e32 = rel_max_err(f_kern, f_plain)
    log(f"[kernel] element force, max |f_kernel - f|/max|f|: vs plain "
        f"f64 {e64:.3e}, vs plain f32 HIGHEST {e32:.3e} "
        f"(plain f32 vs f64 {rel_max_err(f_plain, ref):.3e}); "
        f"tolerance {KERNEL_TOL:g}; kernel compile {t_compile:.2f} s")
    log(f"[kernel] element kernel memory_analysis: "
        f"{comp.memory_analysis()}")
    if not (e64 <= KERNEL_TOL and e32 <= KERNEL_TOL):
        raise RuntimeError("element kernel disagrees with the plain "
                           "brick operator")

    # the whole brick step, kernel vs plain XLA operator, same inputs
    damping = sim.tables.damping
    xs = (jnp.asarray(np.zeros((steps,) + sim.src_forces.shape[1:])
                      if len(sim.src_ids) else np.zeros((steps, 0, 3)),
                      jnp.float32),
          jnp.arange(steps, dtype=jnp.int32))
    for kernel in (True, False):
        step, d = make_brick_step(t_host, meta, TOT, damping, jnp.float32,
                                  kernel=kernel, interpret=interpret)
        state = init_brick_state(meta, TOT, damping, jnp.float32,
                                 n_loose=len(plan.loose_eidx))
        state = (u32, up32, state[2])
        scan = jax.jit(lambda d, s, xs: jax.lax.scan(
            lambda c, x: step(d, c, x), s, xs)[0])
        t0 = time.perf_counter()
        comp = scan.lower(d, state, xs).compile()
        t_compile = time.perf_counter() - t0
        _synced(comp(d, state, xs))
        t0 = time.perf_counter()
        _synced(comp(d, state, xs))
        ms = (time.perf_counter() - t0) / steps * 1e3
        name = "fused kernel" if kernel else "plain XLA"
        log(f"[kernel] brick step, {name}: {ms:.4f} ms/step over {steps} "
            f"steps (block_until_ready), "
            f"{sim.mesh.lenum * 1e3 / ms:.4e} element-updates/s, compile "
            f"{t_compile:.2f} s; card {card}")
        log(f"[kernel] brick step, {name}, memory_analysis: "
            f"{comp.memory_analysis()}")
    log(f"[kernel] peak_bytes_in_use {peak_bytes()}")
    return e64, e32


def reference_phase(out, freq_hz=REF_FREQ_HZ, end_s=END_S):
    """f32 brick path vs the f64 unstructured oracle on TeraShake at
    `freq_hz`.  Returns the relative max-norm difference."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from hercules_tpu.sim import Simulation
    from hercules_tpu.solver.bricks import build_plan
    from hercules_tpu.solver.brickstep import brick_u_global
    from hercules_tpu.tools.cases import prepare_terashake
    if not jax.config.jax_enable_x64:
        raise RuntimeError("the f64 oracle needs jax_enable_x64")
    run = os.path.join(out, f"terashake_{freq_hz:g}hz")
    shutil.rmtree(run, ignore_errors=True)
    cvmdb, phys, num = prepare_terashake(run, freq_hz, end_s)
    sim = Simulation.setup(phys, num, cvmdb=cvmdb)
    st32, _ = sim.run(dtype=jnp.float32, ndev=1)
    path32 = sim.solver_path_name
    if path32 != "bricks":
        raise RuntimeError(f"f32 run took {path32!r}, not the brick path")
    u32 = brick_u_global(build_plan(sim.mesh), st32[0], sim.mesh.nnum)
    st64, _ = sim.run(dtype=jnp.float64, solver="unstructured", ndev=1)
    u64 = np.asarray(st64[0])
    err = rel_max_err(u32, u64)
    log(f"[reference] TeraShake {freq_hz:g} Hz, {sim.mesh.lenum} elements, "
        f"{sim.params.total_steps} steps: f32 {path32} vs f64 "
        f"{sim.solver_path_name}, max|u32 - u64|/max|u64| = {err:.3e} "
        f"(tolerance {REF_TOL:g}), max|u64| = {np.abs(u64).max():.6e} m")
    if not err <= REF_TOL:
        raise RuntimeError("f32 brick path disagrees with the f64 oracle")
    return err


def gpu_tests_phase():
    import pytest
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "-p", "no:randomly", os.path.join(ROOT, "tests")])
    log(f"[gpu tests] pytest -m gpu exit code {int(rc)}")
    if rc != 0:
        raise RuntimeError(f"pytest -m gpu failed ({int(rc)})")


def four_phase(out, card, freq_hz=MAIN_FREQ_HZ, end_s=END_S):
    """TeraShake split over four cards vs one card, same steps."""
    import jax.numpy as jnp
    from hercules_tpu.sim import Simulation
    from hercules_tpu.solver.bricks import build_plan
    from hercules_tpu.solver.brickstep import brick_u_global
    from hercules_tpu.tools.cases import prepare_terashake
    run = os.path.join(out, f"terashake_{freq_hz:g}hz_four")
    shutil.rmtree(run, ignore_errors=True)
    cvmdb, phys, num = prepare_terashake(run, freq_hz, end_s)
    sim = Simulation.setup(phys, num, cvmdb=cvmdb)
    log(f"[four] TeraShake {freq_hz:g} Hz: {sim.mesh.lenum} elements, "
        f"{sim.params.total_steps} steps; mesh {sim.timings['mesh']:.1f} s")
    t0 = time.perf_counter()
    st4, _ = sim.run(dtype=jnp.float32, ndev=4)
    t4 = time.perf_counter() - t0
    path4 = sim.solver_path_name
    u4 = sim.mc_path.u_global(st4)
    t0 = time.perf_counter()
    st1, _ = sim.run(dtype=jnp.float32, ndev=1)
    t1 = time.perf_counter() - t0
    u1 = brick_u_global(build_plan(sim.mesh), st1[0], sim.mesh.nnum)
    err = rel_max_err(u4, u1)
    log(f"[four] {path4} on 4 cards vs {sim.solver_path_name} on 1 card: "
        f"max|u4 - u1|/max|u1| = {err:.3e} (tolerance {FOUR_TOL:g}); "
        f"wall incl. table build and compile: 4 cards {t4:.1f} s, 1 card "
        f"{t1:.1f} s; card {card}")
    if not err <= FOUR_TOL:
        raise RuntimeError("four-card run disagrees with the one-card run")
    return err


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    four = "--four" in argv
    if not os.path.isdir(os.path.join(ROOT, "hercules_tpu")):
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 2
    # the card only: JAX fails at start-up when it finds no GPU
    os.environ.setdefault("JAX_PLATFORMS", "cuda")
    sys.path.insert(0, ROOT)
    import jax
    from hercules_tpu.utils.compile_cache import setup_compile_cache
    setup_compile_cache()
    os.makedirs(OUT, exist_ok=True)
    n_cards = 4 if four else 1
    card = device_phase(n_cards)
    if four:
        four_phase(OUT, card)
    else:
        sim = main_path(OUT)
        jax.config.update("jax_enable_x64", True)
        kernel_phase(sim, card)
        del sim
        reference_phase(OUT)
        gpu_tests_phase()
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
