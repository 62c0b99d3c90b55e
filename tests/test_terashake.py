"""End-to-end terashake-class run: the reference's examples/terashake
config (600x300x84.4 km SCEC box, planewithkinks kinematic rupture)
with an in-tree synthetic layered CVM standing in for the SCEC
database (which is not shipped), at reduced frequency/steps so the
test stays small.  Inputs are the committed examples/terashake/run."""

import numpy as np
import pytest

import jax.numpy as jnp

from hercules_tpu.config import load_params
from hercules_tpu.cvm import CVM
from hercules_tpu.meshgen import generate_mesh

@pytest.fixture(scope="module")
def tera_dir(tmp_path_factory):
    """Run directory from the committed inputs (examples/terashake/run:
    the reduced 50x8-cell rupture and the layered stand-in CVM) at
    0.0125 Hz for 4 s."""
    from hercules_tpu.tools.cases import prepare_terashake
    d = tmp_path_factory.mktemp("tera")
    prepare_terashake(str(d), 0.0125, 4.0)
    return d


def test_terashake_mesh_and_run(tera_dir):
    d = tera_dir
    p = load_params(str(d / "in" / "physics.in"),
                    str(d / "in" / "numerical.in"))
    assert p.region_length_east_m == 600000.0
    p.source_directory = str(d / "in" / "src")
    cvm = CVM(str(d / "tera_layers.e"))
    mesh = generate_mesh(p, cvm)
    # graded mesh: smaller elements in the soft basin than at depth
    assert len(np.unique(mesh.elem_level)) >= 2
    assert mesh.lenum > 1000
    # hanging nodes exist at the grading interfaces
    assert len(mesh.dn_ids) > 0

    from hercules_tpu.source.model import SourceModel
    from hercules_tpu.solver.assemble import assemble
    from hercules_tpu.solver.step import run_solver

    sm = SourceModel.parse(p)
    assert sm.type_of_source == "planewithkinks"
    ids, forces = sm.compute_forces(mesh, p)
    assert sm.total_m0 > 0
    T = p.total_steps
    assert T == 200

    tables = assemble(mesh, p)
    state, _ = run_solver(tables, ids, forces, T, p.delta_t,
                          dtype=jnp.float64)
    u = np.asarray(state[0])
    assert np.isfinite(u).all()
    assert np.abs(u).max() > 1e-8

    # brick path on the graded mesh agrees with the unstructured one
    from hercules_tpu.solver.bricks import build_plan
    from hercules_tpu.solver.brickstep import (brick_u_global,
                                               run_brick_solver)
    plan = build_plan(mesh)
    # hybrid plan: dense brick(s) + loose graded-shell elements
    assert len(plan.bricks) >= 1
    assert len(plan.loose_eidx) > 0
    assert (sum(int(np.prod(b.shape)) for b in plan.bricks)
            + len(plan.loose_eidx)) == mesh.lenum
    bstate, _ = run_brick_solver(plan, tables, ids, forces, T,
                                 p.delta_t, dtype=jnp.float64)
    ub = brick_u_global(plan, bstate[0], mesh.nnum)
    scale = np.abs(u).max()
    np.testing.assert_allclose(ub / scale, u / scale, atol=1e-9)
