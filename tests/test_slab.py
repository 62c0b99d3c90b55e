import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from hercules_tpu.config import load_params
from hercules_tpu.cvm import CVM
from hercules_tpu.meshgen import generate_mesh
from hercules_tpu.parallel.slab import (build_slab_tables,
                                        run_slab_solver, slab_u_global)
from hercules_tpu.solver.assemble import assemble
from hercules_tpu.solver.step import run_solver

SIMPLE = "/root/reference/examples/simple"


@pytest.mark.parametrize("ndev", [3, 4, 5, 8])
def test_slab_matches_single(ndev):
    """16x16x8-element mesh: ndev 3 and 5 exercise the UNEVEN z-split
    (8 = 3+3+2 and 2+2+2+1+1) with dynamic bottom-plane offsets."""
    p = load_params(f"{SIMPLE}/in/physics.in", f"{SIMPLE}/in/numerical.in")
    cvm = CVM(f"{SIMPLE}/simple_case.e")
    mesh = generate_mesh(p, cvm)
    tables = assemble(mesh, p)
    nid = mesh.elem_lnid[mesh.lenum // 2, 0]
    src_ids = np.array([nid], np.int32)
    T = 100
    forces = np.zeros((T, 1, 3))
    forces[:10, 0, :] = 1e8

    state, _ = run_solver(tables, src_ids, forces, T, p.delta_t,
                          dtype=jnp.float64)
    u_ref = np.asarray(state[0])

    st = build_slab_tables(mesh, tables, ndev, src_ids=src_ids)
    devs = np.array(jax.devices()[:ndev])
    with Mesh(devs, ("d",)) as m:
        sh = run_slab_solver(st, m, forces, T, p.delta_t,
                             dtype=jnp.float64, chunk=50)
    u = slab_u_global(st, sh[0], mesh.nnum)
    np.testing.assert_allclose(u, u_ref, rtol=1e-9, atol=1e-18)


def test_slab_rejects_graded_mesh():
    from hercules_tpu.mesh import Octree, extract_mesh
    from hercules_tpu.material import correct_properties, MeshOrigin
    p = load_params(f"{SIMPLE}/in/physics.in", f"{SIMPLE}/in/numerical.in")
    cvm = CVM(f"{SIMPLE}/simple_case.e")
    tree = Octree.newtree(1000.0, 1000.0, 500.0)

    def setrec(tr, hi, lo, lv):
        return {"lv": lv}

    def toexpand(tr, hi, lo, lv, rec):
        from hercules_tpu.etree import morton
        x, y, z = morton.deinterleave3(hi, lo)
        near = (x < (1 << 29)) & (y < (1 << 29)) & (z < (1 << 28))
        return lv < np.where(near, 5, 4)

    tree.refine(setrec, toexpand)
    tree.balance()
    mesh = extract_mesh(tree)
    correct_properties(mesh, cvm, p, MeshOrigin.from_params(p, cvm.ctl))
    tables = assemble(mesh, p)
    with pytest.raises(RuntimeError):
        build_slab_tables(mesh, tables, 4)


def test_slab_bkt_matches_single():
    """BKT convolutional damping on the slab path: memory-variable
    recursion is element-local, so only the same force-plane exchange
    is needed; result matches the single-device brick solver."""
    p = load_params(f"{SIMPLE}/in/physics.in", f"{SIMPLE}/in/numerical.in")
    p.type_of_damping = "bkt"
    p.finalize()
    cvm = CVM(f"{SIMPLE}/simple_case.e")
    mesh = generate_mesh(p, cvm)
    tables = assemble(mesh, p)
    nid = mesh.elem_lnid[mesh.lenum // 2, 0]
    src_ids = np.array([nid], np.int32)
    T = 100
    forces = np.zeros((T, 1, 3))
    forces[:10, 0, :] = 1e8

    state, _ = run_solver(tables, src_ids, forces, T, p.delta_t,
                          dtype=jnp.float64)
    u_ref = np.asarray(state[0])

    st = build_slab_tables(mesh, tables, 4, src_ids=src_ids)
    devs = np.array(jax.devices()[:4])
    with Mesh(devs, ("d",)) as m:
        sh = run_slab_solver(st, m, forces, T, p.delta_t,
                             dtype=jnp.float64, chunk=50)
    u = slab_u_global(st, sh[0], mesh.nnum)
    np.testing.assert_allclose(u, u_ref, rtol=1e-9, atol=1e-18)


def test_slab_unaffected_by_axis_reorder(monkeypatch):
    """Large-plane meshes trigger the mesh-global axis reorder for the
    fused kernels, but the slab decomposition pins the legacy z-major
    layout (its XLA step has no VMEM envelope) and must keep working.
    HT_PALLAS_TILE shrunk so the small mesh triggers the reorder."""
    from hercules_tpu.solver.bricks import build_plan

    monkeypatch.setenv("HT_PALLAS_TILE", "256")
    p = load_params(f"{SIMPLE}/in/physics.in", f"{SIMPLE}/in/numerical.in")
    cvm = CVM(f"{SIMPLE}/simple_case.e")
    mesh = generate_mesh(p, cvm)
    tables = assemble(mesh, p)
    # the default plan reorders under the shrunken tile...
    plan = build_plan(mesh)
    assert plan.bricks[0].axes != (2, 1, 0)
    # ...but the slab path still builds and matches the oracle
    nid = mesh.elem_lnid[mesh.lenum // 2, 0]
    src_ids = np.array([nid], np.int32)
    T = 20
    forces = np.zeros((T, 1, 3))
    forces[:5, 0, :] = 1e8
    state, _ = run_solver(tables, src_ids, forces, T, p.delta_t,
                          dtype=jnp.float64)
    u_ref = np.asarray(state[0])
    st = build_slab_tables(mesh, tables, 4, src_ids=src_ids)
    devs = np.array(jax.devices()[:4])
    with Mesh(devs, ("d",)) as m:
        sh = run_slab_solver(st, m, forces, T, p.delta_t,
                             dtype=jnp.float64, chunk=10)
    u = slab_u_global(st, sh[0], mesh.nnum)
    np.testing.assert_allclose(u, u_ref, rtol=1e-9, atol=1e-18)

