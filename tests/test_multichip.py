"""End-to-end tests of the production multi-chip pipeline
(parallel/driver.py + Simulation._run_multichip): the full solver_run
surface — stations, 4-D volume output, planes, checkpoint write AND
restart (psolve.c:4241-4324) — on the 8-virtual-device CPU mesh,
equality-checked against the single-device run."""

import os
import shutil

import numpy as np
import pytest

import jax.numpy as jnp

from hercules_tpu.config import load_params
from hercules_tpu.cvm import CVM
from hercules_tpu.meshgen import generate_mesh
from hercules_tpu.sim import Simulation, SimOutputs, setup_stations
from hercules_tpu.solver.assemble import assemble
from hercules_tpu.io.output4d import read_4d
from hercules_tpu.io.planes import read_plane

SIMPLE = "/root/reference/examples/simple"


@pytest.fixture(scope="module")
def simple_setup():
    p = load_params(f"{SIMPLE}/in/physics.in",
                    f"{SIMPLE}/in/numerical.in")
    p.end_time = 0.2                       # 200 steps
    p.output_displacement = 1
    p.output_velocity = 1
    p.output_rate = 10
    p.number_output_planes = 1
    p.planes_print_rate = 20
    p.planes = np.array([[500.0, 500.0, 0.0, 100.0, 5, 100.0, 3,
                          0.0, 90.0]])
    p.use_checkpoint = 1
    p.checkpointing_rate = 100
    p.finalize()
    cvm = CVM(f"{SIMPLE}/simple_case.e")
    mesh = generate_mesh(p, cvm)
    tables = assemble(mesh, p)
    from hercules_tpu.source.model import SourceModel
    src = SourceModel.parse(p)
    src_ids, src_forces = src.compute_forces(mesh, p)
    return p, cvm, mesh, tables, src, src_ids, src_forces


def _make_sim(simple_setup):
    p, cvm, mesh, tables, src, src_ids, src_forces = simple_setup
    return Simulation(params=p, cvm=cvm, mesh=mesh, tables=tables,
                      source=src, src_ids=src_ids,
                      src_forces=src_forces,
                      stations=setup_stations(mesh, p))


def _run(sim, rundir, ndev=None, prefer=None, with_outputs=True):
    p = sim.params
    p.output_displacement_file = os.path.join(rundir, "disp.h4d")
    p.output_velocity_file = os.path.join(rundir, "vel.h4d")
    p.planes_dir = os.path.join(rundir, "planes")
    p.checkpoint_path = os.path.join(rundir, "ckpt")
    outputs = SimOutputs(sim.mesh, p, rundir=rundir) \
        if with_outputs else None
    return sim.run(dtype=jnp.float64, outputs=outputs, rundir=rundir,
                   ndev=ndev, mc_path=prefer)


@pytest.fixture(scope="module")
def single_run(simple_setup, tmp_path_factory):
    """Single-device oracle with full outputs."""
    rundir = str(tmp_path_factory.mktemp("single"))
    sim = _make_sim(simple_setup)
    state, samples = _run(sim, rundir)
    return rundir, samples


@pytest.mark.parametrize("prefer", ["slab", "sharded"])
def test_mc_full_pipeline_matches_single(simple_setup, single_run,
                                         tmp_path, prefer):
    """hpsolve on 8 virtual devices: stations + 4-D + planes +
    checkpoints, equal to the single-device run."""
    ref_dir, ref_samples = single_run
    rundir = str(tmp_path)
    sim = _make_sim(simple_setup)
    state, samples = _run(sim, rundir, ndev=8, prefer=prefer)
    assert sim.mc_path_name == prefer

    # all five station seismograms match to 1e-9 (f64, different
    # summation order only)
    assert samples.shape == ref_samples.shape
    scale = np.abs(ref_samples).max()
    np.testing.assert_allclose(samples, ref_samples,
                               atol=1e-9 * scale, rtol=1e-9)

    # 4-D volume files match
    _, ref_d = read_4d(os.path.join(ref_dir, "disp.h4d"))
    _, mc_d = read_4d(os.path.join(rundir, "disp.h4d"))
    np.testing.assert_allclose(mc_d, ref_d, atol=1e-9 * scale,
                               rtol=1e-9)
    _, ref_v = read_4d(os.path.join(ref_dir, "vel.h4d"))
    _, mc_v = read_4d(os.path.join(rundir, "vel.h4d"))
    vs = max(np.abs(ref_v).max(), 1e-30)
    np.testing.assert_allclose(mc_v, ref_v, atol=1e-8 * vs, rtol=1e-8)

    # plane files match
    ref_p = read_plane(os.path.join(ref_dir, "planes",
                                    "planedisplacements.0"), 5, 3)
    mc_p = read_plane(os.path.join(rundir, "planes",
                                   "planedisplacements.0"), 5, 3)
    np.testing.assert_allclose(mc_p, ref_p, atol=1e-9 * scale,
                               rtol=1e-9)

    # checkpoints were written
    outs = sorted(os.listdir(os.path.join(rundir, "ckpt")))
    assert "checkpoint.out0" in outs


@pytest.mark.parametrize("prefer", ["slab", "sharded"])
def test_mc_checkpoint_restart(simple_setup, single_run, tmp_path,
                               prefer):
    """Restart a multi-chip run from its own checkpoint: the resumed
    station tail matches the uninterrupted run to 1e-9."""
    ref_dir, ref_samples = single_run
    rundir = str(tmp_path)
    sim = _make_sim(simple_setup)
    p = sim.params
    state_a, samples_a = _run(sim, rundir, ndev=8, prefer=prefer)

    # pick the checkpoint written at step 100 (rate 100, 200 steps:
    # slots alternate; find the one whose step == 100)
    from hercules_tpu.io.checkpoint import checkpoint_read
    ckdir = os.path.join(rundir, "ckpt")
    chosen = None
    for w in (0, 1):
        f = os.path.join(ckdir, f"checkpoint.out{w}")
        if os.path.exists(f) and checkpoint_read(f)[0] == 100:
            chosen = f
    assert chosen is not None
    shutil.copy(chosen, os.path.join(ckdir, "checkpoint.in"))

    sim_b = _make_sim(simple_setup)
    sim_b.params = p
    state_b, samples_b = _run(sim_b, rundir, ndev=8, prefer=prefer)
    assert sim_b.start_step == 100
    assert samples_b.shape[0] == 100

    scale = np.abs(ref_samples).max()
    np.testing.assert_allclose(samples_b, ref_samples[100:],
                               atol=1e-9 * scale, rtol=1e-9)
    # and the restart is bit-exact vs the uninterrupted mc run
    np.testing.assert_array_equal(np.asarray(state_b[0]),
                                  np.asarray(state_a[0]))
    os.remove(os.path.join(ckdir, "checkpoint.in"))


def test_mc_restart_rejects_wrong_physics(simple_setup, tmp_path):
    """A checkpoint written under a different damping model is
    rejected loudly (ADVICE round 1)."""
    rundir = str(tmp_path)
    sim = _make_sim(simple_setup)
    p = sim.params
    _run(sim, rundir, ndev=8, prefer="slab")
    ckdir = os.path.join(rundir, "ckpt")
    src = os.path.join(ckdir, "checkpoint.out0")
    shutil.copy(src, os.path.join(ckdir, "checkpoint.in"))

    import numpy.lib.npyio
    # tamper the damping record
    with np.load(os.path.join(ckdir, "checkpoint.in")) as z:
        d = {k: z[k] for k in z.files}
    d["damping"] = np.asarray("bkt")
    np.savez(os.path.join(ckdir, "checkpoint.in"), **d)
    # np.savez appends .npz when the name has no extension
    if os.path.exists(os.path.join(ckdir, "checkpoint.in.npz")):
        os.replace(os.path.join(ckdir, "checkpoint.in.npz"),
                   os.path.join(ckdir, "checkpoint.in"))

    sim_b = _make_sim(simple_setup)
    with pytest.raises(RuntimeError, match="damping"):
        _run(sim_b, rundir, ndev=8, prefer="slab")
    os.remove(os.path.join(ckdir, "checkpoint.in"))


def test_mc_no_outputs_station_only(simple_setup, single_run, tmp_path):
    """ndev path without SimOutputs still samples stations correctly
    (pure solver + stations, large chunks)."""
    _, ref_samples = single_run
    sim = _make_sim(simple_setup)
    state, samples = _run(sim, str(tmp_path), ndev=8, prefer="slab",
                          with_outputs=False)
    scale = np.abs(ref_samples).max()
    np.testing.assert_allclose(samples, ref_samples,
                               atol=1e-9 * scale, rtol=1e-9)


# ---------------------------------------------------------------------------
# sharded nonlinear + DRM (VERDICT round-1 item 4): per-element state
# shards with the element partition, as nonlinear.c:1671 / drm.c:2316
# run on every MPI rank in the reference.

def _nl_cfg(model="vonmises", k=2e4, geostatic=False):
    from hercules_tpu.nonlinear import NonlinearConfig
    c = NonlinearConfig()
    c.material_model = model
    c.properties_type = "alphakay"
    c.plasticity_type = "rate_independant"
    c.vs_cut = 1e9
    c.vs_min = 0.0
    c.vs_limits = np.array([0.0, 1e10])
    c.alpha_cohes = np.array([0.0, 0.0])
    c.kay_phis = np.array([k, k])
    c.strain_rates = np.array([1e-3, 1e-3])
    c.sensitivities = np.array([1.0, 1.0])
    c.hardening = np.array([0.0, 0.0])
    if geostatic:
        c.geostatic_loading_t = 0.05
        c.geostatic_cushion_t = 0.01
    return c


@pytest.mark.parametrize("geostatic", [False, True])
def test_mc_sharded_nonlinear_matches_single(geostatic):
    """Sharded vonMises plasticity (+ geostatic gravity loading)
    equals the single-device nonlinear run to 1e-9 on 8 devices."""
    import jax
    from jax.sharding import Mesh
    from hercules_tpu.config import load_params
    from hercules_tpu.nonlinear import build_nonlinear_tables
    from hercules_tpu.parallel.driver import (ShardedPath,
                                              run_multichip)
    from hercules_tpu.parallel.partition import (shard_nonlinear,
                                                 shard_tables)
    from hercules_tpu.solver.step import attach_nonlinear, run_solver

    p = load_params(f"{SIMPLE}/in/physics.in",
                    f"{SIMPLE}/in/numerical.in")
    cvm = CVM(f"{SIMPLE}/simple_case.e")
    mesh = generate_mesh(p, cvm)
    tables = assemble(mesh, p)
    nid = mesh.elem_lnid[mesh.lenum // 2, 0]
    src_ids = np.array([nid], np.int32)
    T = 120
    forces = np.zeros((T, 1, 3))
    forces[:20, 0, :] = 1e8

    cfg = _nl_cfg(geostatic=geostatic)
    nlt = build_nonlinear_tables(mesh, p, cfg)
    nl = attach_nonlinear(mesh, p, tables, nlt)
    state_ref, _ = run_solver(tables, src_ids, forces, T, p.delta_t,
                              dtype=jnp.float64, nl=nl)
    u_ref = np.asarray(state_ref[0])

    ust = shard_tables(tables, mesh, 8, src_ids=src_ids)
    nl_b = shard_nonlinear(ust, tables, mesh, p, nlt, 8)
    path = ShardedPath(ust, mesh, dtype=jnp.float64, nl=nl_b)
    m = Mesh(np.array(jax.devices()[:8]), ("d",))
    state, _ = run_multichip(path, m, forces, T, p.delta_t, chunk=40)
    u = path.u_global(state)
    scale = np.abs(u_ref).max()
    assert scale > 0 and np.isfinite(u).all()
    np.testing.assert_allclose(u / scale, u_ref / scale, atol=1e-9)


def test_mc_sharded_drm_part2_matches_single(tmp_path):
    """Sharded DRM part2 effective-force replay equals the
    single-device part2 run to 1e-9 on 8 devices."""
    import jax
    from jax.sharding import Mesh
    from hercules_tpu.config import ConfigFile, load_params
    from hercules_tpu.drm import (DRMConfig, DRMRecorder, attach_drm,
                                  classify)
    from hercules_tpu.parallel.driver import (ShardedPath,
                                              run_multichip)
    from hercules_tpu.parallel.partition import (shard_drm,
                                                 shard_tables)
    from hercules_tpu.solver.step import run_solver

    p = load_params(f"{SIMPLE}/in/physics.in",
                    f"{SIMPLE}/in/numerical.in")
    p.type_of_damping = "none"
    p.finalize()
    cvm = CVM(f"{SIMPLE}/simple_case.e")
    mesh = generate_mesh(p, cvm)
    tables = assemble(mesh, p)

    cfg_txt = ("drm_directory  = {d}\nwhich_drm_part = {part}\n"
               "drm_edgesize   = 62.5\ndrm_offset_x   = 0\n"
               "drm_offset_y   = 0\ndrm_print_rate = 1\n"
               "part1_delta_t  = 0.001\ndrm_boundary =\n"
               "250.0 250.0 750.0 750.0 250.0\n")

    def cfg(part):
        f = tmp_path / f"drm_{part}.in"
        f.write_text(cfg_txt.format(d=str(tmp_path), part=part))
        return DRMConfig.parse(ConfigFile(str(f)))

    plan = classify(mesh, cfg("part1"))
    from hercules_tpu.mesh.locate import locate_points
    found, eidx = locate_points(mesh, [100.0], [100.0], [100.0])
    nid = mesh.elem_lnid[eidx[0], 0]
    T = 120
    forces = np.zeros((T, 1, 3))
    forces[:20, 0, :] = 1e8
    src_ids = np.array([nid], np.int32)

    L = len(plan.node_ids)
    st_nodes = np.zeros((L, 8), np.int32)
    st_nodes[:, 0] = plan.node_ids
    st_phi = np.zeros((L, 8))
    st_phi[:, 0] = 1.0
    _, rec = run_solver(tables, src_ids, forces, T, p.delta_t,
                        st_nodes=st_nodes, st_phi=st_phi,
                        dtype=jnp.float64)
    recorder = DRMRecorder(str(tmp_path), plan)
    for s in range(T):
        full = np.zeros((mesh.nnum, 3))
        full[plan.node_ids] = rec[s]
        recorder.record(s, full)
    recorder.close()

    plan2 = classify(mesh, cfg("part2"))
    drm = attach_drm(plan2, tables, p, str(tmp_path))
    zeros = np.zeros((T, 1, 3))
    state_ref, _ = run_solver(tables, src_ids, zeros, T, p.delta_t,
                              dtype=jnp.float64, drm=dict(drm))
    u_ref = np.asarray(state_ref[0])

    ust = shard_tables(tables, mesh, 8, src_ids=src_ids)
    drm_b = shard_drm(ust, drm, 8)
    path = ShardedPath(ust, mesh, dtype=jnp.float64, drm=drm_b)
    m = Mesh(np.array(jax.devices()[:8]), ("d",))
    state, _ = run_multichip(path, m, zeros, T, p.delta_t, chunk=40)
    u = path.u_global(state)
    scale = np.abs(u_ref).max()
    assert scale > 0
    np.testing.assert_allclose(u / scale, u_ref / scale, atol=1e-9)


def test_mc_fixed_base_matches_single(tmp_path):
    """VERDICT r3 item 6: fixed-base buildings under the multi-chip
    driver — the prescribed base displacements shard like stations
    (every device sets its local copies) and the 8-device run equals
    the single-device unstructured solution exactly
    (buildings.c:975-1146)."""
    from hercules_tpu.buildings import Buildings
    from hercules_tpu.config import ConfigFile
    from hercules_tpu.solver.step import run_solver

    cfg = tmp_path / "bldg.in"
    cfg.write_text("""
number_of_buildings = 1
buildings_n_factor  = 2
min_octant_size_m   = 62.5
surface_shift_m     = 62.5
consider_fixed_base = no
building_properties =
  437.5  562.5  437.5  562.5  62.5  62.5  1000 500 2000 2000 1000 2200
""")
    p = load_params(f"{SIMPLE}/in/physics.in",
                    f"{SIMPLE}/in/numerical.in")
    cvm = CVM(f"{SIMPLE}/simple_case.e")
    b = Buildings.parse(ConfigFile(str(cfg)))
    mesh = generate_mesh(p, cvm, buildings=b)
    tables = assemble(mesh, p)
    ids, which = b.base_nodes(mesh)
    T = 100
    series = np.zeros((T, len(ids), 3))
    series[:, :, 0] = np.linspace(0, 1e-3, T)[:, None]
    series[:, :, 1] = np.sin(np.linspace(0, 3.0, T))[:, None] * 1e-4
    forces = np.zeros((T, 1, 3))
    src_ids = np.array([0], np.int32)

    state_ref, _ = run_solver(tables, src_ids, forces, T, p.delta_t,
                              dtype=jnp.float64, fb_ids=ids,
                              fb_series=series)
    u_ref = np.asarray(state_ref[0])

    import jax
    from jax.sharding import Mesh
    from hercules_tpu.parallel.driver import ShardedPath, run_multichip
    from hercules_tpu.parallel.partition import (shard_fixedbase,
                                                 shard_tables)

    ust = shard_tables(tables, mesh, 8, src_ids=src_ids)
    fb_b = shard_fixedbase(ust, ids, 8)
    path = ShardedPath(ust, mesh, dtype=jnp.float64, fb=fb_b,
                       fb_series=series)
    m = Mesh(np.array(jax.devices()[:8]), ("d",))
    state, _ = run_multichip(path, m, forces, T, p.delta_t, chunk=40)
    u = path.u_global(state)
    scale = np.abs(u_ref).max()
    assert scale > 0
    np.testing.assert_allclose(u / scale, u_ref / scale, atol=1e-9)
    # base nodes carry exactly the prescribed series
    np.testing.assert_allclose(u[ids], series[-1], rtol=1e-12)


def test_mc_sim_dispatch_fixed_base(tmp_path):
    """Simulation.run(ndev=8) with consider_fixed_base=yes routes to
    the sharded path (no single-device fallback) and matches the
    single-device run."""
    import shutil as _sh
    run = tmp_path / "run"
    (run / "in").mkdir(parents=True)
    _sh.copy(f"{SIMPLE}/in/physics.in", run / "in" / "physics.in")
    _sh.copytree(f"{SIMPLE}/in/sourcefiles", run / "in" / "sourcefiles")
    num = open(f"{SIMPLE}/in/numerical.in").read()
    num = num.replace("simulation_end_time_sec        =  20",
                      "simulation_end_time_sec        =  0.1")
    num += """
include_buildings = yes
number_of_buildings = 1
buildings_n_factor  = 2
min_octant_size_m   = 62.5
surface_shift_m     = 62.5
consider_fixed_base = yes
fixedbase_input_dt = 0.01
fixedbase_input_dir = fb
fixedbase_input_startindex = 0
fixedbase_input_sufix = base
building_properties =
  437.5  562.5  437.5  562.5  62.5  62.5  1000 500 2000 2000 1000 2200
"""
    (run / "in" / "numerical.in").write_text(num)
    d = run / "fb"
    d.mkdir()
    t = np.arange(60) * 0.01
    np.savetxt(d / "base.0", np.stack([np.sin(t), 0 * t, 0 * t], 1))

    def mk():
        return Simulation.setup(str(run / "in" / "physics.in"),
                                str(run / "in" / "numerical.in"),
                                cvmdb=f"{SIMPLE}/simple_case.e")

    state_ref, _ = mk().run(dtype=jnp.float64, rundir=str(run))
    u_ref = np.asarray(state_ref[0])

    sim = mk()
    state, _ = sim.run(dtype=jnp.float64, rundir=str(run), ndev=8)
    assert sim.mc_path_name == "sharded"
    u = sim_mc_u_global(sim, state)
    scale = np.abs(u_ref).max()
    assert scale > 0
    np.testing.assert_allclose(u / scale, u_ref / scale, atol=1e-9)


def sim_mc_u_global(sim, state):
    """Assemble the global displacement field from a multi-chip run's
    final state via the path the Simulation actually used."""
    return sim.mc_path.u_global(state)

