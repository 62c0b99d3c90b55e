import os

import numpy as np
import pytest

import jax.numpy as jnp

from hercules_tpu.config import load_params, ConfigFile
from hercules_tpu.cvm import CVM
from hercules_tpu.drm import (DRMConfig, DRMPlan, DRMRecorder, attach_drm,
                              classify, effective_force_records,
                              read_coords, read_displacements)
from hercules_tpu.meshgen import generate_mesh
from hercules_tpu.solver.assemble import assemble
from hercules_tpu.solver.step import run_solver

SIMPLE = "/root/reference/examples/simple"

DRM_CFG = """
drm_directory  = {d}
which_drm_part = {part}
drm_edgesize   = 62.5
drm_offset_x   = 0
drm_offset_y   = 0
drm_print_rate = 1
part1_delta_t  = 0.001
drm_boundary =
250.0 250.0 750.0 750.0 250.0
"""


def _cfg(tmp_path, part):
    p = tmp_path / f"drm_{part}.in"
    p.write_text(DRM_CFG.format(d=str(tmp_path), part=part))
    return DRMConfig.parse(ConfigFile(str(p)))


@pytest.fixture(scope="module")
def setup():
    p = load_params(f"{SIMPLE}/in/physics.in", f"{SIMPLE}/in/numerical.in")
    p.type_of_damping = "none"
    cvm = CVM(f"{SIMPLE}/simple_case.e")
    mesh = generate_mesh(p, cvm)
    tables = assemble(mesh, p)
    return p, mesh, tables


def test_classify(setup, tmp_path):
    p, mesh, tables = setup
    cfg = _cfg(tmp_path, "part0")
    plan = classify(mesh, cfg)
    assert len(plan.elem_idx) > 0
    # every DRM element has both boundary and exterior corners
    nb = plan.mask_b.sum(axis=1)
    assert (nb > 0).all() and (nb < 8).all()
    # interface is a closed box surface: boundary corners lie on the box
    ts = mesh.ticksize
    for k in range(len(plan.elem_idx)):
        e = plan.elem_idx[k]
        # spot-check a few
        if k > 10:
            break


def test_part0_writes_coords(setup, tmp_path):
    p, mesh, tables = setup
    cfg = _cfg(tmp_path, "part0")
    plan = classify(mesh, cfg)
    from hercules_tpu.drm import write_coords
    write_coords(str(tmp_path), plan)
    coords = read_coords(str(tmp_path))
    assert coords.shape == (len(plan.node_ids), 3)


def test_drm_reproduces_interior_field(setup, tmp_path):
    """The DRM exactness property: with an unperturbed part2 model, the
    replayed effective forces reproduce the interior wavefield exactly
    and produce zero scattered field outside."""
    p, mesh, tables = setup
    cfg = _cfg(tmp_path, "part1")
    plan = classify(mesh, cfg)

    # source OUTSIDE the DRM box (near a corner of the domain)
    from hercules_tpu.mesh.locate import locate_points
    found, eidx = locate_points(mesh, [100.0], [100.0], [100.0])
    assert found[0]
    nid = mesh.elem_lnid[eidx[0], 0]
    T = 160
    forces = np.zeros((T, 1, 3))
    forces[:20, 0, :] = 1e8
    src_ids = np.array([nid], np.int32)

    # ---- PART1: record interface displacements every step ----
    L = len(plan.node_ids)
    st_nodes = np.zeros((L, 8), np.int32)
    st_nodes[:, 0] = plan.node_ids
    st_phi = np.zeros((L, 8))
    st_phi[:, 0] = 1.0
    state1, rec = run_solver(tables, src_ids, forces, T, p.delta_t,
                             st_nodes=st_nodes, st_phi=st_phi,
                             dtype=jnp.float64)
    u1 = np.asarray(state1[0])

    # write the records in the part1 format
    recorder = DRMRecorder(str(tmp_path), plan)
    for s in range(T):
        full = np.zeros((mesh.nnum, 3))
        full[plan.node_ids] = rec[s]
        recorder.record(s, full)
    recorder.close()

    # ---- PART2: replay with zero source ----
    cfg2 = _cfg(tmp_path, "part2")
    plan2 = classify(mesh, cfg2)
    drm = attach_drm(plan2, tables, p, str(tmp_path))
    zeros = np.zeros((T, 1, 3))
    state2, _ = run_solver(tables, src_ids, zeros, T, p.delta_t,
                           dtype=jnp.float64, drm=drm)
    u2 = np.asarray(state2[0])

    ts = mesh.ticksize
    nx = mesh.node_x.astype(np.float64) * ts
    ny = mesh.node_y.astype(np.float64) * ts
    nz = mesh.node_z.astype(np.float64) * ts
    inside = ((nx >= 250) & (nx <= 750) & (ny >= 250) & (ny <= 750)
              & (nz <= 250))
    # strictly interior: not a corner of any DRM element
    drm_nodes = np.zeros(mesh.nnum, bool)
    drm_nodes[plan.node_ids] = True
    interior = inside & ~drm_nodes
    exterior = ~inside & ~drm_nodes

    scale = np.abs(u1).max()
    assert scale > 0
    # interior field reproduced
    np.testing.assert_allclose(u2[interior] / scale,
                               u1[interior] / scale, atol=1e-9)
    # no scattered field outside (model unperturbed)
    np.testing.assert_allclose(u2[exterior] / scale, 0, atol=1e-9)


def test_sim_part1_streams_records(tmp_path):
    """The sim-level part1 wiring records interface displacements via
    in-scan one-hot station sampling streamed through on_samples (full
    chunking on any solver path), matching a manual one-hot run; the
    regular station samples come back unpolluted."""
    import jax.numpy as jnp
    from hercules_tpu.drm import classify, read_displacements
    from hercules_tpu.sim import Simulation

    sim = Simulation.setup(f"{SIMPLE}/in/physics.in",
                           f"{SIMPLE}/in/numerical.in",
                           cvmdb=f"{SIMPLE}/simple_case.e")
    cfg = _cfg(tmp_path, "part1")
    sim.drm_plan = classify(sim.mesh, cfg)
    sim.drm_dir = str(tmp_path)
    T = 50
    sim.src_forces = sim.src_forces[:T]
    state, samples = sim.run(total_steps=T, chunk=20,
                             dtype=jnp.float64)
    n_st = len(sim.stations.ids) if sim.stations else 0
    assert samples.shape[1] == n_st       # drm rows sliced off

    plan = sim.drm_plan
    L = len(plan.node_ids)
    st_nodes = np.zeros((L, 8), np.int32)
    st_nodes[:, 0] = plan.node_ids
    st_phi = np.zeros((L, 8))
    st_phi[:, 0] = 1.0
    _, rec = run_solver(sim.tables, sim.src_ids, sim.src_forces, T,
                        sim.params.delta_t, st_nodes=st_nodes,
                        st_phi=st_phi, dtype=jnp.float64)

    got = read_displacements(str(tmp_path), L)    # [nrec, L, 3]
    assert got.shape[0] == T          # steps 0..T-1 at print_rate 1
    np.testing.assert_allclose(got[0], 0.0)
    scale = max(np.abs(np.asarray(rec)).max(), 1e-30)
    np.testing.assert_allclose(got[1:] / scale,
                               np.asarray(rec)[1:] / scale, atol=1e-12)

    # ... and through the multi-chip driver (8 virtual devices)
    mc_dir = tmp_path / "mc"
    mc_dir.mkdir()
    sim2 = Simulation.setup(f"{SIMPLE}/in/physics.in",
                            f"{SIMPLE}/in/numerical.in",
                            cvmdb=f"{SIMPLE}/simple_case.e")
    sim2.drm_plan = classify(sim2.mesh, _cfg(mc_dir, "part1"))
    sim2.drm_dir = str(mc_dir)
    sim2.src_forces = sim2.src_forces[:T]
    _, samples2 = sim2.run(total_steps=T, chunk=20,
                           dtype=jnp.float64, ndev=8)
    assert samples2.shape[1] == n_st
    got2 = read_displacements(str(mc_dir), L)
    assert got2.shape[0] == T
    np.testing.assert_allclose(got2[1:] / scale,
                               np.asarray(rec)[1:] / scale, atol=1e-9)
