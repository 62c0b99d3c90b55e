"""The fused elastic brick element kernel (solver/brick_kernel.py)
against the plain XLA brick operator and a NumPy reference, in Pallas'
interpreter on the CPU and compiled on the card (marker `gpu`)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from hercules_tpu.physics.kmats import stiffness_matrices_24
from hercules_tpu.solver import brick_kernel
from hercules_tpu.solver.brick_kernel import make_elastic_force, program_table
from hercules_tpu.solver.bricks import Brick
from hercules_tpu.solver.brickstep import (BrickMeta, make_brick_step,
                                           plain_elastic_force,
                                           use_element_kernel)

M1, M2 = stiffness_matrices_24()
MCAT = np.concatenate([M1.T, M2.T], axis=0).T          # [24, 48]

# (brick shapes in elements, storage axes, loose tail nodes)
CASES = {
    # several programs, S not a multiple of the block
    "one_brick": ([(12, 10, 5)], (2, 1, 0), 0),
    # corner reach o7 (one xy plane) far beyond the block
    "large_o7": ([(40, 30, 2)], (2, 1, 0), 0),
    # reordered axes, two bricks and a loose-node tail
    "bricks_and_loose": ([(6, 7, 3), (9, 4, 4)], (1, 2, 0), 100),
    # a single element: S = 1
    "one_element": ([(1, 1, 1)], (2, 1, 0), 0),
}


def synthetic(case, seed=0):
    """(meta, TOT, c, u, up) for bricks of the given shapes; element
    coefficients are zero on the node-grid positions that hold no
    element, as assemble_brick_tables makes them."""
    shapes, axes, loose = CASES[case]
    meta, valid = [], []
    off = 0
    for sh in shapes:
        b = Brick(level=0, origin=np.zeros(3, np.int64), shape=np.array(sh))
        b._axes = axes
        dims = b.node_shape
        nb = int(np.prod(dims))
        offs = tuple(b.corner_offsets())
        meta.append(BrickMeta(off=off, nb=nb, S=nb - offs[7], offs=offs))
        idx = np.meshgrid(*[np.arange(k) for k in dims], indexing="ij")
        ixyz = {a: idx[k] for k, a in enumerate(axes)}
        valid.append(((ixyz[0] < sh[0]) & (ixyz[1] < sh[1])
                      & (ixyz[2] < sh[2])).ravel())
        off += nb
    TOT = off + loose
    valid = np.concatenate(valid + [np.zeros(loose, bool)])
    rng = np.random.default_rng(seed)
    c = {k: np.where(valid, rng.uniform(0.5, 1.5, TOT) * s, 0.0)
         for k, s in (("c1", 1.0), ("c2", 2.0), ("c3", 0.01),
                      ("c4", 0.02))}
    u = rng.standard_normal((3, TOT))
    up = u + 1e-2 * rng.standard_normal((3, TOT))
    return meta, TOT, c, u, up


def numpy_force(meta, TOT, c, u, up):
    """Element-by-element NumPy statement of the brick operator."""
    f = np.zeros((3, TOT))
    for m in meta:
        q = m.off + np.arange(m.S)
        ue = np.concatenate([u[:, q + o] for o in m.offs])     # [24, S]
        du = ue - np.concatenate([up[:, q + o] for o in m.offs])
        ab = np.concatenate([c["c1"][q] * ue + c["c3"][q] * du,
                             c["c2"][q] * ue + c["c4"][q] * du])
        fe = -(MCAT @ ab)
        for j, o in enumerate(m.offs):
            np.add.at(f, (slice(None), q + o), fe[3 * j:3 * j + 3])
    return f


def kernel_force(meta, TOT, c, u, up, dtype, interpret, block=None):
    kw = {} if block is None else {"block": block}
    fn, tab = make_elastic_force(meta, TOT, MCAT, dtype,
                                 interpret=interpret, **kw)
    args = [jnp.asarray(tab), jnp.asarray(u, dtype), jnp.asarray(up, dtype)]
    args += [jnp.asarray(c[k], dtype) for k in ("c1", "c2", "c3", "c4")]
    return np.asarray(jax.jit(fn)(*args), np.float64)


def rel_err(a, ref):
    return np.abs(a - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype,tol", [(jnp.float64, 1e-13),
                                       (jnp.float32, 1e-5)])
def test_kernel_interpret_matches_plain(case, dtype, tol):
    meta, TOT, c, u, up = synthetic(case)
    ref = numpy_force(meta, TOT, c, u, up)
    d = {"mcat": jnp.asarray(MCAT, dtype),
         **{k: jnp.asarray(v, dtype) for k, v in c.items()}}
    plain = np.asarray(plain_elastic_force(
        d, jnp.asarray(u, dtype), jnp.asarray(up, dtype), meta, TOT),
        np.float64)
    kern = kernel_force(meta, TOT, c, u, up, dtype, interpret=True)
    assert rel_err(plain, ref) < tol
    assert rel_err(kern, ref) < tol
    # loose nodes carry no brick force
    assert not kern[:, sum(m.nb for m in meta):].any()


@pytest.mark.parametrize("block", [16, 64])
def test_kernel_block_sizes(block):
    """Smaller blocks: many programs, partial last programs per brick."""
    meta, TOT, c, u, up = synthetic("bricks_and_loose", seed=1)
    ref = numpy_force(meta, TOT, c, u, up)
    kern = kernel_force(meta, TOT, c, u, up, jnp.float64, interpret=True,
                        block=block)
    assert rel_err(kern, ref) < 1e-13


@pytest.mark.parametrize("block", [16, 256])
def test_program_table_covers_every_node_once(block):
    meta, TOT, *_ = synthetic("bricks_and_loose")
    tab = program_table(meta, TOT, block)
    assert tab.dtype == np.int32 and tab.shape[1] == 12
    hits = np.zeros(TOT, int)
    for start, boff, bend, S, *offs in tab:
        assert boff <= start < bend
        hits[start:min(start + block, bend)] += 1
        if boff >= meta[-1].off + meta[-1].nb:      # loose tail
            assert S == 0
        else:
            m = next(m for m in meta if m.off == boff)
            assert (bend, S, tuple(offs)) == (m.off + m.nb, m.S, m.offs)
    assert (hits == 1).all()


@pytest.mark.parametrize("platform,damping,want", [
    ("gpu", "rayleigh", True), ("gpu", "none", True),
    ("gpu", "bkt", False), ("cpu", "rayleigh", False)])
def test_kernel_choice_by_platform(platform, damping, want):
    assert use_element_kernel(damping, platform) is want


def test_cpu_default_is_plain_operator():
    assert jax.default_backend() == "cpu"
    assert use_element_kernel("rayleigh") is False


def test_kernel_refuses_bkt():
    with pytest.raises(ValueError, match="elastic-only"):
        make_brick_step({"n_groups": 0, "dn_grp": np.zeros(0)}, [], 0,
                        "bkt", kernel=True)


def test_axis_reorder_keyed_to_kernel_halo(monkeypatch, terashake_small):
    """bricks.build_plan reorders storage axes exactly when some brick's
    legacy corner reach exceeds the kernel's halo limit."""
    from hercules_tpu.solver.bricks import build_plan
    mesh = terashake_small.mesh
    plan = build_plan(mesh)
    assert all(b.axes == (2, 1, 0) for b in plan.bricks)
    o7 = max(b.corner_offsets()[7] for b in plan.bricks)
    monkeypatch.setattr(brick_kernel, "HALO_NODES", o7 - 1)
    plan = build_plan(mesh)
    assert all(b.axes != (2, 1, 0) for b in plan.bricks)
    assert max(b.corner_offsets()[7] for b in plan.bricks) < o7


@pytest.fixture(scope="module")
def terashake_small(tmp_path_factory):
    """TeraShake from the committed inputs at 0.0125 Hz (25,600
    elements: one brick plus loose graded-transition elements)."""
    from hercules_tpu.sim import Simulation
    from hercules_tpu.tools.cases import prepare_terashake
    run = tmp_path_factory.mktemp("terashake")
    cvmdb, phys, num = prepare_terashake(str(run), 0.0125, 4.0)
    return Simulation.setup(phys, num, cvmdb=cvmdb)


def test_brick_step_kernel_matches_plain_terashake(terashake_small):
    """The whole brick step (source, loose elements, reconciliation)
    with the interpreted kernel equals the plain step on a real graded
    mesh."""
    from hercules_tpu.solver.bricks import build_plan
    from hercules_tpu.solver.brickstep import assemble_brick_tables
    sim = terashake_small
    plan = build_plan(sim.mesh)
    assert len(plan.loose_eidx) > 0
    t, meta, TOT = assemble_brick_tables(plan, sim.tables,
                                         src_ids=sim.src_ids)
    rng = np.random.default_rng(3)
    carry = (jnp.asarray(rng.standard_normal((3, TOT))),
             jnp.asarray(rng.standard_normal((3, TOT))), ())
    x = (jnp.asarray(sim.src_forces[50]), jnp.int32(50))
    out = []
    for kernel in (False, True):
        step, d = make_brick_step(t, meta, TOT, "rayleigh", jnp.float64,
                                  kernel=kernel, interpret=True)
        (u, _, _), _ = jax.jit(step)(d, carry, x)
        out.append(np.asarray(u))
    assert rel_err(out[1], out[0]) < 1e-13


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_on_card_matches_numpy(gpu, case):
    meta, TOT, c, u, up = synthetic(case)
    ref = numpy_force(meta, TOT, c, u, up)
    kern = kernel_force(meta, TOT, c, u, up, jnp.float32, interpret=False)
    assert rel_err(kern, ref) < 1e-5


@pytest.mark.gpu
def test_brick_step_picks_kernel_on_card(gpu):
    assert use_element_kernel("rayleigh") is True
