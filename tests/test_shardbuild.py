"""Shard-local slab table construction (parallel/shardbuild.py):
build_slab_tables_shard over P thread ranks must reproduce the global
build_slab_tables output BITWISE — coefficients, masses (ordered
cross-rank accumulation), gnid maps, sources, BKT rows — while every
rank touches only O(shard + its slab) rows (octor.c:5267-6651 /
psolve.c:4705-4863 per-rank-tables semantics)."""

import threading

import numpy as np
import pytest

from hercules_tpu.config import load_params
from hercules_tpu.cvm import CVM
from hercules_tpu.mesh.distributed import (LocalComm,
                                           generate_mesh_shard)
from hercules_tpu.meshgen import generate_mesh
from hercules_tpu.parallel.shardbuild import build_slab_tables_shard
from hercules_tpu.parallel.slab import build_slab_tables
from hercules_tpu.solver.assemble import assemble

SIMPLE = "/root/reference/examples/simple"


def run_ranks(nproc, fn):
    comms = LocalComm.group(nproc)
    results = [None] * nproc
    errs = []

    def worker(r):
        try:
            results[r] = fn(comms[r])
        except BaseException as e:   # noqa: BLE001 - test harness
            errs.append((r, e))
            comms[r]._sh["barrier"].abort()

    ts = [threading.Thread(target=worker, args=(r,))
          for r in range(nproc)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    if errs:
        raise errs[0][1]
    return results


@pytest.mark.parametrize("damping,nproc,n_dev", [
    ("rayleigh", 2, 4),
    ("rayleigh", 3, 8),
    ("bkt", 2, 4),
])
def test_shard_slab_tables_equal_global(damping, nproc, n_dev):
    p = load_params(f"{SIMPLE}/in/physics.in",
                    f"{SIMPLE}/in/numerical.in")
    p.type_of_damping = damping
    cvm = CVM(f"{SIMPLE}/simple_case.e")
    mesh = generate_mesh(p, cvm)
    tables = assemble(mesh, p)
    src_ids = np.array([mesh.elem_lnid[mesh.lenum // 2, 0],
                        mesh.elem_lnid[3, 6]], np.int32)
    ref = build_slab_tables(mesh, tables, n_dev, src_ids=src_ids)

    # device ranges per process (contiguous, like a pod)
    splits = [(r * n_dev // nproc, (r + 1) * n_dev // nproc)
              for r in range(nproc)]

    def build(comm):
        cvm_r = CVM(f"{SIMPLE}/simple_case.e")
        shard = generate_mesh_shard(p, cvm_r, comm,
                                    coarse_leaves_per_rank=8)
        # small exchange chunk to exercise the bounded rounds
        import hercules_tpu.parallel.shardbuild as sb
        return build_slab_tables_shard(
            shard, p, comm, n_dev, src_gnids=src_ids,
            dev_slice=splits[comm.rank])

    sts = run_ranks(nproc, build)
    for rk, st in enumerate(sts):
        d0, d1 = splits[rk]
        assert st.dev0 == d0
        assert (st.nzp, st.nyp, st.nxp) == (ref.nzp, ref.nyp, ref.nxp)
        assert st.tot_local == ref.tot_local
        assert tuple(st.meta.offs) == tuple(ref.meta.offs)
        assert st.meta.S == ref.meta.S
        np.testing.assert_array_equal(st.ez_of, ref.ez_of)
        np.testing.assert_array_equal(st.m48, ref.m48)
        for k in st.c:
            np.testing.assert_array_equal(st.c[k], ref.c[k][d0:d1],
                                          err_msg=k)
        np.testing.assert_array_equal(st.inv_mass,
                                      ref.inv_mass[d0:d1])
        np.testing.assert_array_equal(st.mass_minusaM,
                                      ref.mass_minusaM[d0:d1])
        for d in range(d0, d1):
            np.testing.assert_array_equal(
                st.gnid_local[d][:len(ref.gnid_local[d])],
                ref.gnid_local[d])
        np.testing.assert_array_equal(st.src_lidx,
                                      ref.src_lidx[d0:d1])
        np.testing.assert_array_equal(st.src_mask,
                                      ref.src_mask[d0:d1])
        if damping == "bkt":
            for k in ref.bkt:
                np.testing.assert_array_equal(st.bkt[k],
                                              ref.bkt[k][d0:d1],
                                              err_msg=k)
            np.testing.assert_array_equal(st.kmu, ref.kmu)
            np.testing.assert_array_equal(st.kkappa, ref.kkappa)


def test_shard_slab_tables_reject_graded():
    """Graded meshes must raise (fallback to the gather_mesh path)."""
    from hercules_tpu.etree import morton
    from hercules_tpu.mesh import Octree
    from hercules_tpu.mesh.distributed import (choose_intervals,
                                               extract_mesh_shard,
                                               shard_tree,
                                               balance_distributed)

    def te(tr, hi, lo, lv, rec):
        x, y, z = morton.deinterleave3(hi, lo)
        return lv < np.where(z < (1 << 28), 5, 4)

    p = load_params(f"{SIMPLE}/in/physics.in",
                    f"{SIMPLE}/in/numerical.in")

    def build(comm):
        tree = Octree.newtree(1000.0, 1000.0, 500.0)
        while tree.n < 8 * comm.nproc:
            lmin = int(tree.level.min())
            tree.refine(lambda tr, hi, lo, lv: {},
                        lambda tr, hi, lo, lv, rec, _l=lmin:
                        lv <= _l)
        starts = choose_intervals(tree, np.ones(tree.n), comm.nproc)
        tree, _ = shard_tree(tree, starts, comm.rank)
        tree.refine(lambda tr, hi, lo, lv: {}, te)
        balance_distributed(tree, starts, comm)
        shard = extract_mesh_shard(tree, starts, comm)
        shard.props = {"Vp": np.full(shard.lenum, 6000.0),
                       "Vs": np.full(shard.lenum, 3464.0),
                       "rho": np.full(shard.lenum, 2700.0)}
        with pytest.raises(RuntimeError, match="uniform brick"):
            build_slab_tables_shard(shard, p, comm, 2)
        return True

    assert all(run_ranks(2, build))
