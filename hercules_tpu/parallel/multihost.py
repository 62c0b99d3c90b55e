"""Multi-host execution: the cluster-scale analogue of the
reference's MPI ranks (SURVEY section 2.7; BASELINE config 5).

The reference scales by adding MPI ranks connected over the
interconnect; every rank meshes its partition and exchanges halos
point-to-point.  The shape here is: one JAX process per host (or, when
several processes share a machine, one per card: --local-device),
`jax.distributed.initialize` over the network, a single global device
mesh whose slab axis spans every host's cards (NVLink inside a host,
the network across hosts), and the SAME shard_map slab step as
single-host runs --
XLA routes the per-step plane `ppermute`s over whichever fabric
connects neighboring shards.  Meshing stays host-side and SHARDED:
every process refines/balances/extracts only its Z-order block
(mesh/distributed.py, octor_partitiontree semantics), so no host
builds or broadcasts the global tree; `broadcast_from_host0` remains
for small config objects (the reference's PE0 parse-and-broadcast,
psolve.c:367-483).  Each process feeds its own device shards through
`jax.make_array_from_callback`.

Every entry point here is process-count agnostic: with one process the
same code runs unchanged on a local multi-device mesh.  The test suite
validates both shapes (tests/test_multihost.py): single-process
8-device equality with the standard slab solver, and a real 2-process
jax.distributed CPU run (gloo collectives) of the full mesh-broadcast-
solve pipeline against the single-process oracle.
"""

from __future__ import annotations

import pickle

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def init_multihost(coordinator=None, num_processes=None,
                   process_id=None, local_device_ids=None):
    """jax.distributed bring-up; no-op for single-process runs.

    Returns (process_count, process_index) as seen by the backend.
    """
    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
            local_device_ids=local_device_ids)
    return jax.process_count(), jax.process_index()


def global_device_mesh(axis="d") -> Mesh:
    """One-axis mesh over every device of every process (slab axis)."""
    return Mesh(np.array(jax.devices()), (axis,))


def broadcast_from_host0(obj):
    """Pickle-broadcast a host object from process 0 to all processes
    (the PE0 read-and-broadcast pattern for mesh arrays / config)."""
    if jax.process_count() == 1:
        return obj
    from jax.experimental import multihost_utils
    payload = pickle.dumps(obj) if jax.process_index() == 0 else b""
    n = multihost_utils.broadcast_one_to_all(
        np.int64(len(payload)))
    buf = np.zeros(int(n), np.uint8)
    if jax.process_index() == 0:
        buf[:] = np.frombuffer(payload, np.uint8)
    buf = multihost_utils.broadcast_one_to_all(buf)
    return pickle.loads(buf.tobytes())


def make_global(arr, mesh: Mesh, spec) -> jax.Array:
    """Build a global array on `mesh` from a full host copy: each
    process materializes only its addressable shards (the callback
    slices the host array), so no process needs to hold device memory
    for remote shards."""
    arr = np.asarray(arr)
    sh = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(arr.shape, sh,
                                        lambda idx: arr[idx])


def make_global_shards(arr_local, d0, mesh: Mesh, axis="d") -> jax.Array:
    """Global [n_dev, ...] array from a host-LOCAL stacked slice
    [n_local, ...] whose first row is global device d0: each process
    holds host memory only for its own devices' table rows
    (build_slab_tables dev_slice) — no host materializes the pod's
    full tables."""
    arr_local = np.asarray(arr_local)
    n_dev = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    sh = NamedSharding(mesh, P(axis))
    shape = (n_dev,) + arr_local.shape[1:]

    def cb(idx):
        s = idx[0]
        start = 0 if s.start is None else s.start
        stop = shape[0] if s.stop is None else s.stop
        return arr_local[start - d0 : stop - d0]

    return jax.make_array_from_callback(shape, sh, cb)


def gather_global(x) -> np.ndarray:
    """Full host copy of a (possibly process-spanning) global array."""
    if jax.process_count() == 1:
        return np.asarray(x)
    from jax.experimental import multihost_utils
    return np.asarray(multihost_utils.process_allgather(
        x, tiled=True))


def correct_properties_multihost(mesh, cvm, params, origin=None,
                                 buildings=None):
    """mesh_correct_properties sharded over processes: each host runs
    the 27-point CVM averaging (the mesh-time hot loop,
    psolve.c:7104-7331) for its contiguous element block only, then
    the per-element property columns are allgathered.  This removes
    the host-0 serial bottleneck the reference avoided by meshing on
    every rank (octor.c:4904)."""
    from ..material import MeshOrigin, correct_properties

    if origin is None:
        origin = MeshOrigin.from_params(params, cvm.ctl)
    nproc, pid = jax.process_count(), jax.process_index()
    if nproc == 1:
        correct_properties(mesh, cvm, params, origin,
                           buildings=buildings)
        return mesh
    import copy
    E = mesh.lenum
    lo = pid * E // nproc
    hi = (pid + 1) * E // nproc
    sub = copy.copy(mesh)
    sub.elem_x = mesh.elem_x[lo:hi]
    sub.elem_y = mesh.elem_y[lo:hi]
    sub.elem_z = mesh.elem_z[lo:hi]
    sub.elem_level = mesh.elem_level[lo:hi]
    sub.elem_lnid = mesh.elem_lnid[lo:hi]
    sub.edge_m = mesh.edge_m[lo:hi]
    sub.props = {}
    correct_properties(sub, cvm, params, origin, buildings=buildings)
    # allgather the property columns (tiled over the element axis)
    from jax.experimental import multihost_utils
    pad = (E + nproc - 1) // nproc      # equal per-process chunk
    mesh.props = {}
    for k, v in sub.props.items():
        buf = np.zeros(pad, v.dtype)
        buf[: hi - lo] = v
        full = np.asarray(multihost_utils.process_allgather(buf))
        # rows are per-process [nproc, pad]; reassemble exact blocks
        out = np.empty(E, v.dtype)
        for q in range(nproc):
            ql = q * E // nproc
            qh = (q + 1) * E // nproc
            out[ql:qh] = full[q, : qh - ql]
        mesh.props[k] = out
    return mesh


def run_slab_multihost(st, src_forces, total_steps, dt,
                       dtype=jnp.float32, chunk=None, axis="d"):
    """Slab solver over the global (multi-host) device mesh.

    st: SlabTables built identically on every process (from the
    broadcast mesh arrays).  Same contract as run_slab_solver, but all
    device state is constructed shard-locally via make_global, so it
    works with addressable-only device subsets.
    """
    from .slab import make_slab_step

    mesh_dev = global_device_mesh(axis)
    n_dev = st.n_dev
    assert n_dev == len(jax.devices()), \
        f"slab tables built for {n_dev} shards but the global mesh " \
        f"has {len(jax.devices())} devices"
    scan_fn, tdev = make_slab_step(st, mesh_dev, axis=axis, dtype=dtype)

    npdt = np.dtype(jnp.zeros((), dtype).dtype)
    sharded = lambda a: make_global(a, mesh_dev, P(axis))
    repl = lambda a: make_global(a, mesh_dev, P())
    local_rows = int(np.asarray(st.c["c1"] if st.c else
                                st.inv_mass).shape[0])
    if local_rows != n_dev:
        # per-host table build (build_slab_tables dev_slice): stacked
        # rows cover only this host's devices, starting at st.dev0
        tdev = jax.tree.map(
            lambda a: make_global_shards(a, st.dev0, mesh_dev, axis),
            tdev)
    else:
        tdev = jax.tree.map(lambda a: sharded(np.asarray(a)), tdev)

    u = np.zeros((n_dev, 3, st.tot_local), npdt)
    if st.damping == "bkt":
        conv = tuple(sharded(np.zeros((n_dev, 24, st.meta.S), npdt))
                     for _ in range(4))
        state = (sharded(u), sharded(u), conv)
    else:
        state = (sharded(u), sharded(u))

    if chunk is None:
        chunk = min(total_steps, 1000)
    dt2 = dt * dt
    s = 0
    while s < total_steps:
        k = min(chunk, total_steps - s)
        xs = (repl(np.asarray(src_forces[s:s + k] * dt2, npdt)),
              repl(np.arange(s, s + k, dtype=np.int32)))
        state = scan_fn(tdev, state, xs)
        s += k
    return state


def local_device_slice():
    """(d0, d1): this process's contiguous range in jax.devices()
    order (the slab-table dev_slice).  Asserts contiguity — JAX
    orders global devices process-major on standard pods."""
    ids = {id(d): i for i, d in enumerate(jax.devices())}
    idx = sorted(ids[id(d)] for d in jax.local_devices())
    assert idx == list(range(idx[0], idx[-1] + 1)), \
        f"non-contiguous local device ids {idx}"
    return idx[0], idx[-1] + 1


def compute_forces_multihost(sm, shard, params, comm,
                             chunk_bytes=64 << 20):
    """Global (node_ids, forces [T, L, 3]) from per-shard source
    location: each rank locates and evaluates only the sources inside
    its shard (locate_points' ancestor check assigns each point to
    exactly one shard), then the per-node force series merge by
    summation in bounded allgather rounds.  Duplicate-node sums
    accumulate in rank order (vs. global point order), so cross-rank
    shared nodes can differ from the serial build by float rounding
    only."""
    ids, F = sm.compute_forces(shard, params, props=shard.props,
                               partial=True)
    T = params.total_steps
    nloc = int(getattr(sm, "located_points", len(ids)))
    ntot = comm.allreduce_sum(nloc)
    if sm.type_of_source == "point" and ntot != 1:
        raise RuntimeError(f"point source located by {ntot} shards")
    if sm.type_of_source == "srfh" and ntot != len(sm.src_lon):
        raise RuntimeError(
            f"srfh: {ntot}/{len(sm.src_lon)} points located")
    if ntot == 0:
        raise RuntimeError("source entirely outside mesh")

    # global id set
    idrows = [g for g in comm.allgather_rows(
        np.asarray(ids, np.float64)[:, None]) if len(g)]
    gids = (np.unique(np.concatenate(idrows)[:, 0]).astype(np.int64)
            if idrows else np.zeros(0, np.int64))
    L = len(gids)
    pos = np.searchsorted(gids, np.asarray(ids, np.int64))
    out = np.zeros((T, L, 3))
    # time-chunked row exchange: [local L, k*3] blocks (k collective —
    # allgather widths must match across ranks)
    lmax = comm.allreduce_max(len(ids))
    k = max(1, int(chunk_bytes // max(lmax, 1) // 24))
    for s in range(0, T, k):
        kk = min(k, T - s)
        blk = np.concatenate(
            [np.asarray(ids, np.float64)[:, None],
             F[s:s + kk].transpose(1, 0, 2).reshape(len(ids),
                                                    kk * 3)], axis=1)
        for got in comm.allgather_rows(blk):
            if not len(got):
                continue
            p = np.searchsorted(gids, got[:, 0].astype(np.int64))
            np.add.at(out[s:s + kk],
                      (slice(None), p),
                      got[:, 1:].reshape(len(got), kk, 3)
                      .transpose(1, 0, 2))
    return gids.astype(np.int32), out


def run_shard_slab_pipeline(params, shard, comm):
    """The O(shard) pod pipeline tail: shard-local slab tables ->
    multihost slab solve, with NO process ever holding the global
    mesh or global-length solver tables (octor.c:4904-6651 +
    psolve.c:4705-4863 per-rank scalability, matched).  Raises
    RuntimeError when the mesh is not slab-decomposable (callers fall
    back to the gather_mesh chain).  Returns (st, state)."""
    from ..source.model import SourceModel
    from .shardbuild import build_slab_tables_shard

    from .shardbuild import attach_sources_shard

    n_dev = len(jax.devices())
    # the table build decides slab-decomposability BEFORE the source
    # pass (fail fast into the fallback chain)
    st = build_slab_tables_shard(shard, params, comm, n_dev,
                                 dev_slice=local_device_slice())
    sm = SourceModel.parse(params)
    src_ids, src_forces = compute_forces_multihost(sm, shard, params,
                                                   comm)
    attach_sources_shard(st, shard, src_ids, comm)
    state = run_slab_multihost(st, src_forces, params.total_steps,
                               params.delta_t)
    return st, state


def main(argv=None):
    """Pod launcher: `python -m hercules_tpu.parallel.multihost
    --coordinator host0:1234 --nprocs N --pid K <cvmdb> <physics.in>
    <numerical.in>` -- process 0 meshes, everyone solves."""
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--nprocs", type=int, default=1)
    ap.add_argument("--pid", type=int, default=0)
    ap.add_argument("--local-device", type=int, default=None,
                    help="the one local card this process uses; required "
                         "when several processes run on one machine")
    ap.add_argument("inputs", nargs="+")
    args = ap.parse_args(argv)

    nproc, pid = init_multihost(
        args.coordinator, args.nprocs, args.pid,
        local_device_ids=(None if args.local_device is None
                          else [args.local_device]))
    print(f"[multihost] process {pid}/{nproc}, "
          f"{len(jax.local_devices())} local / {len(jax.devices())} "
          f"global devices")

    from ..config import load_params
    from ..cvm import CVM
    from ..meshgen import generate_mesh
    from ..solver.assemble import assemble
    from ..source.model import SourceModel
    from .slab import build_slab_tables, slab_u_global

    cvmdb, physics_in, numerical_in = args.inputs[:3]
    params = load_params(physics_in, numerical_in)

    if nproc == 1:
        mesh = generate_mesh(params, CVM(cvmdb))
    else:
        # O(shard) pipeline first: sharded meshing -> shard-local
        # slab tables -> solve, no global mesh on any process
        # (octor.c:4904-6651 scalability).  Non-slab meshes fall
        # through to the gather_mesh chain below.
        from ..mesh.distributed import JaxComm, gather_mesh, \
            generate_mesh_shard
        comm = JaxComm()
        shard = generate_mesh_shard(params, CVM(cvmdb), comm)
        try:
            st, state = run_shard_slab_pipeline(params, shard, comm)
            loc = max(float(np.abs(np.asarray(s.data)).max())
                      for s in state[0].addressable_shards)
            print(f"[multihost] done (shard slab, O(shard) memory): "
                  f"process {pid} local |u|max = {loc:.6e}")
            return 0
        except RuntimeError as e:
            print(f"[multihost] shard slab pipeline unavailable "
                  f"({e}); gathering the global mesh")
            mesh = gather_mesh(shard, comm)

    tables = assemble(mesh, params)
    sm = SourceModel.parse(params)
    src_ids, src_forces = sm.compute_forces(mesh, params)
    # table construction decides the decomposition: slab for a single
    # uniform brick, else the unstructured sharded path (single-process
    # only).  A RuntimeError mid-solve propagates.
    try:
        st = build_slab_tables(mesh, tables, len(jax.devices()),
                               src_ids=src_ids)
    except RuntimeError as e:
        from .partition import shard_tables
        from .sharded import gather_global as sh_gather, run_sharded
        if nproc > 1:
            raise RuntimeError(
                "the unstructured sharded path is single-process only "
                "(its tables are not built shard-locally); re-mesh to a "
                "slab-decomposable shape for pod runs") from e
        print(f"[multihost] slab decomposition unavailable ({e}); "
              f"using the unstructured sharded path")
        ust = shard_tables(tables, mesh, len(jax.devices()),
                           src_ids=src_ids)
        state = run_sharded(ust, global_device_mesh(), src_forces,
                            params.total_steps, params.delta_t)
        if pid == 0:
            ug = sh_gather(ust, state[0], mesh.nnum)
            print(f"[multihost] done (unstructured): "
                  f"|u|max = {np.abs(ug).max():.6e}")
        return 0
    state = run_slab_multihost(st, src_forces, params.total_steps,
                               params.delta_t)
    u = gather_global(state[0])
    if pid == 0:
        ug = slab_u_global(st, u, mesh.nnum)
        print(f"[multihost] done: |u|max = {np.abs(ug).max():.6e}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
