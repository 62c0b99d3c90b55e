"""Benchmark of the brick path on one card: element-updates/s and
ms/step, and wall seconds per simulated second for TeraShake.

    BENCH_CONFIG=uniform    (default) the reference's homogeneous box
                            (1000 x 1000 x 500 m) refined to BENCH_ELEMS
                            elements, CVM generated by build_layered_cvm
    BENCH_CONFIG=terashake  TeraShake from examples/terashake/run at
                            BENCH_TERA_FREQ Hz (default 0.1, ~11.3M
                            elements)
    BENCH_CONFIG=meshscale  host meshing throughput (no device work)

BENCH_STEPS sets the timed steps.  Every number is printed with the
device it ran on; the device paths refuse to run without a GPU.
"""

import json
import os
import sys
import tempfile
import time

import numpy as np


def device_info(require_gpu=True):
    import jax
    devs = jax.devices()
    if require_gpu and devs[0].platform != "gpu":
        raise RuntimeError(f"no GPU: JAX platform is {devs[0].platform}")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def time_brick_path(sim, steps):
    """Compile and time `steps` steps of the brick path (the kernel
    choice of make_brick_step) on the Simulation's mesh, fenced by
    block_until_ready.  Returns a dict of set-up and step numbers."""
    import jax
    import jax.numpy as jnp
    from hercules_tpu.solver.bricks import build_plan
    from hercules_tpu.solver.brickstep import (assemble_brick_tables,
                                               init_brick_state,
                                               make_brick_step,
                                               use_element_kernel)
    t0 = time.perf_counter()
    plan = build_plan(sim.mesh)
    t_host, meta, TOT = assemble_brick_tables(plan, sim.tables,
                                              src_ids=sim.src_ids)
    damping = sim.tables.damping
    step, d = make_brick_step(t_host, meta, TOT, damping, jnp.float32)
    t_plan = time.perf_counter() - t0
    state = init_brick_state(meta, TOT, damping, jnp.float32,
                             n_loose=len(plan.loose_eidx))
    L = sim.src_forces.shape[1]
    xs = (jnp.asarray(np.asarray(sim.src_forces[:steps])
                      * sim.params.delta_t ** 2, jnp.float32),
          jnp.arange(steps, dtype=jnp.int32))
    scan = jax.jit(lambda d, s, xs: jax.lax.scan(
        lambda c, x: step(d, c, x), s, xs)[0])
    t0 = time.perf_counter()
    comp = scan.lower(d, state, xs).compile()
    t_compile = time.perf_counter() - t0
    state = comp(d, state, xs)
    jax.block_until_ready(state)
    t0 = time.perf_counter()
    state = comp(d, state, xs)
    jax.block_until_ready(state)
    wall = time.perf_counter() - t0
    E = sim.mesh.lenum
    stats = jax.devices()[0].memory_stats() or {}
    return {"elements": E, "bricks": len(meta),
            "loose_elements": int(len(plan.loose_eidx)), "sources": L,
            "element_kernel": use_element_kernel(damping),
            "steps": steps, "ms_per_step": wall / steps * 1e3,
            "element_updates_per_s": E * steps / wall,
            "wall_s_per_sim_s": wall / steps / sim.params.delta_t,
            "mesh_s": sim.timings["mesh"],
            "assemble_s": sim.timings["assemble"],
            "plan_s": t_plan, "compile_s": t_compile,
            "peak_bytes_in_use": stats.get("peak_bytes_in_use", -1)}


def setup_uniform(target, steps):
    from hercules_tpu.sim import Simulation
    from hercules_tpu.tools.cases import write_homogeneous_case
    run = tempfile.mkdtemp(prefix="ht_uniform_")
    cvmdb, phys, num = write_homogeneous_case(run, target, steps=steps)
    return Simulation.setup(phys, num, cvmdb=cvmdb)


def setup_terashake(freq, steps):
    from hercules_tpu.sim import Simulation
    from hercules_tpu.tools.cases import prepare_terashake
    run = tempfile.mkdtemp(prefix="ht_terashake_")
    # TeraShake's dt is 0.02 s
    cvmdb, phys, num = prepare_terashake(run, freq, steps * 0.02)
    return Simulation.setup(phys, num, cvmdb=cvmdb)


def mesh_scale_bench():
    """BENCH_CONFIG=meshscale: reference-design-scale meshing demo
    (octor meshed O(1e9) elements across thousands of ranks, Tu et al.
    2006; SURVEY.md section 6).  Runs the host meshing pipeline —
    progressive refinement (factor-of-2 steps, psolve.c:2002-2090),
    2-to-1 balance, extraction with dangling classification — at
    >= 1e8 elements on one host using the native kernels
    (cpp/meshkernels.cpp), and reports element throughput + peak RSS.

    Material assignment (mesh_correct_properties' 27-point CVM
    averaging) is benchmarked separately per 1e6 queries — it is
    embarrassingly parallel across hosts in production and would
    otherwise dominate a single-core demo."""
    import resource

    from hercules_tpu.mesh import Octree, extract_mesh

    target = int(os.environ.get("BENCH_MESH_ELEMS", 134_217_728))
    L = int(np.ceil(np.log2(target) / 3.0))       # cube: 8**L elems
    t0 = time.time()
    tree = Octree.newtree(1000.0, 1000.0, 1000.0)

    def setrec(tr, hi, lo, lv):
        return {"lv": lv}

    phases = {}
    # progressive meshing: refine one level at a time, balancing after
    # each step (use_progressive_meshing semantics)
    for step_lv in range(1, L + 1):
        def toexpand(tr, hi, lo, lv, rec, _sl=step_lv):
            return np.full(np.shape(hi), lv < _sl)

        t1 = time.time()
        tree.refine(setrec, toexpand)
        phases[f"refine->L{step_lv}"] = time.time() - t1
        t1 = time.time()
        tree.balance()
        phases[f"balance L{step_lv}"] = time.time() - t1
    t1 = time.time()
    mesh = extract_mesh(tree)
    phases["extract"] = time.time() - t1
    dt = time.time() - t0
    E = mesh.lenum
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    for k, v in phases.items():
        print(f"# {k}: {v:.1f}s", file=sys.stderr)
    print(f"# meshscale: {E} elements, {mesh.nnum} nodes, "
          f"{len(mesh.dn_ids)} dangling in {dt:.1f}s "
          f"({E/dt:.3e} elem/s), peak RSS {rss:.1f} GB",
          file=sys.stderr)
    # sharded meshing (mesh/distributed.py): the same pipeline over
    # BENCH_MESH_RANKS in-process ranks — reports per-rank shard
    # sizes and the per-rank ARRAY bytes (= the per-process memory a
    # real jax.distributed run needs; thread RSS is shared, so array
    # accounting is the honest per-process figure)
    ranks = int(os.environ.get("BENCH_MESH_RANKS", "0"))
    if ranks > 1:
        import threading
        from hercules_tpu.mesh.distributed import (
            LocalComm, balance_distributed, choose_intervals,
            extract_mesh_shard, shard_tree)

        def run_rank(comm, out):
            tr = Octree.newtree(1000.0, 1000.0, 1000.0)
            while tr.n < 8 * comm.nproc:
                lmin = int(tr.level.min())
                tr.refine(lambda t_, hi, lo, lv: {},
                          lambda t_, hi, lo, lv, rec, _l=lmin:
                          lv <= _l)
            starts = choose_intervals(tr, np.ones(tr.n), comm.nproc)
            tr, _ = shard_tree(tr, starts, comm.rank)
            for step_lv in range(1, L + 1):
                tr.refine(lambda t_, hi, lo, lv: {},
                          lambda t_, hi, lo, lv, rec, _sl=step_lv:
                          np.full(np.shape(hi), lv < _sl))
                balance_distributed(tr, starts, comm)
            sh = extract_mesh_shard(tr, starts, comm)
            nbytes = sum(np.asarray(a).nbytes for a in
                         (sh.elem_x, sh.elem_y, sh.elem_z,
                          sh.elem_level, sh.elem_lnid, sh.node_x,
                          sh.node_y, sh.node_z, sh.dn_ids,
                          sh.dn_anchors, sh.edge_m))
            # O(shard) solver-table build (parallel/shardbuild.py):
            # SlabTables for this rank's device WITHOUT the global
            # mesh; per-rank table bytes = the real per-process
            # memory of a pod run
            from hercules_tpu.config import Params
            from hercules_tpu.parallel.shardbuild import \
                build_slab_tables_shard
            E_l = sh.lenum
            sh.props = {"Vp": np.full(E_l, 6000.0),
                        "Vs": np.full(E_l, 3464.0),
                        "rho": np.full(E_l, 2700.0)}
            prm = Params(region_length_east_m=1000.0,
                         region_length_north_m=1000.0,
                         region_depth_deep_m=1000.0,
                         freq=1.0, end_time=1.0, delta_t=1e-3,
                         type_of_damping="rayleigh").finalize()
            st = build_slab_tables_shard(
                sh, prm, comm, comm.nproc,
                dev_slice=(comm.rank, comm.rank + 1))
            tbytes = (sum(v.nbytes for v in st.c.values())
                      + st.inv_mass.nbytes + st.mass_minusaM.nbytes
                      + sum(g.nbytes for g in st.gnid_local
                            if g is not None))
            out[comm.rank] = (sh.lenum, len(sh.node_x),
                              nbytes + tbytes, sh.e_global)
        comms = LocalComm.group(ranks)
        res = [None] * ranks
        t1 = time.time()
        ts = [threading.Thread(target=run_rank, args=(c, res))
              for c in comms]
        for th in ts:
            th.start()
        for th in ts:
            th.join()
        dts = time.time() - t1
        eg = res[0][3]
        emax = max(r[0] for r in res)
        bmax = max(r[2] for r in res)
        print(f"# meshscale sharded x{ranks}: {eg} elements in "
              f"{dts:.1f}s ({eg/dts:.3e} elem/s); largest shard "
              f"{emax} elems ({emax/eg*100:.1f}%), per-rank peak "
              f"bytes (mesh shard + O(shard) slab solver tables) "
              f"<= {bmax/1e6:.1f} MB (vs {E} elems single-host)",
              file=sys.stderr)

    # CVM query throughput (the per-element material pass, measured
    # separately at 1e6 queries against a layered CVM)
    from hercules_tpu.cvm import CVM
    from hercules_tpu.tools.makecvm import build_layered_cvm
    tmp = tempfile.mkdtemp(prefix="ht_meshscale_")
    build_layered_cvm(f"{tmp}/l.e", 1000.0, 1000.0, 1000.0, 62.5,
                      [[0.0, 2000.0, 1000.0, 2100.0],
                       [500.0, 6000.0, 3464.0, 2700.0]])
    cvm = CVM(f"{tmp}/l.e")
    rng = np.random.default_rng(0)
    q = rng.uniform(0, 1000.0, (3, 1_000_000))
    t1 = time.time()
    ok, vp, vs, rho = cvm.query(q[0], q[1], q[2])
    qps = 1_000_000 / (time.time() - t1)
    print(f"# cvm_query: {qps:.3e} queries/s "
          f"(27/elem -> {qps/27:.3e} elem/s material pass)",
          file=sys.stderr)
    print(json.dumps({
        "config": "meshscale", "device": device_info(require_gpu=False),
        "elements": E, "mesh_elements_per_s": E / dt}))


def main():
    config = os.environ.get("BENCH_CONFIG", "uniform")
    if config == "meshscale":
        mesh_scale_bench()
        return
    import jax
    from hercules_tpu.utils.compile_cache import setup_compile_cache
    setup_compile_cache()
    dev = device_info()
    steps = int(os.environ.get("BENCH_STEPS", 200))
    if config == "uniform":
        sim = setup_uniform(int(os.environ.get("BENCH_ELEMS", 1 << 20)),
                            steps)
    elif config == "terashake":
        sim = setup_terashake(
            float(os.environ.get("BENCH_TERA_FREQ", 0.1)), steps)
    else:
        raise ValueError(f"unknown BENCH_CONFIG {config!r}")
    r = time_brick_path(sim, steps)
    print(f"# {config}: {r['elements']} elements, {r['bricks']} bricks, "
          f"{r['ms_per_step']:.4f} ms/step on {dev['kind']} "
          f"x{dev['count']}", file=sys.stderr)
    print(json.dumps({"config": config, "device": dev, **r}))


if __name__ == "__main__":
    main()
