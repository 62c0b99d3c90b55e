"""Multi-host (DCN) skeleton (parallel/multihost.py).

Two layers of validation: (1) every multihost entry point is
process-count agnostic (global arrays built from addressable-shard
callbacks, a process-spanning mesh, broadcast helpers), so the same
code path must reproduce the standard slab solver exactly on the
single-process 8-device CPU mesh; (2) a REAL 2-process
jax.distributed run (gloo CPU collectives, 1 device per process) of
the full pipeline -- host-0 meshing, pickle broadcast, per-process
shard construction, plane-halo ppermutes crossing the process
boundary -- compared against the single-process oracle.  Note: this
jaxlib aggregates cross-process CPU devices only at the default one
device per process (JAX_NUM_CPU_DEVICES/XLA_FLAGS overrides break
aggregation), so the 2-process test runs 2x1 devices.
"""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from hercules_tpu.config import load_params
from hercules_tpu.cvm import CVM
from hercules_tpu.meshgen import generate_mesh
from hercules_tpu.parallel.multihost import (broadcast_from_host0,
                                             gather_global,
                                             global_device_mesh,
                                             init_multihost,
                                             run_slab_multihost)
from hercules_tpu.parallel.slab import (build_slab_tables,
                                        run_slab_solver, slab_u_global)
from hercules_tpu.solver.assemble import assemble

SIMPLE = "/root/reference/examples/simple"


def test_multihost_single_process_matches_slab():
    """The multihost driver on the full 8-device mesh == the standard
    slab solver (identity of the global-array construction path)."""
    p = load_params(f"{SIMPLE}/in/physics.in", f"{SIMPLE}/in/numerical.in")
    cvm = CVM(f"{SIMPLE}/simple_case.e")
    mesh = generate_mesh(p, cvm)
    tables = assemble(mesh, p)
    n_dev = len(jax.devices())
    assert n_dev == 8                    # conftest forces the CPU mesh

    nproc, pid = init_multihost()
    assert (nproc, pid) == (1, 0)
    assert broadcast_from_host0({"a": 1}) == {"a": 1}

    nid = mesh.elem_lnid[mesh.lenum // 2, 0]
    src_ids = np.array([nid], np.int32)
    T = 80
    forces = np.zeros((T, 1, 3))
    forces[:10, 0, :] = 1e8
    st = build_slab_tables(mesh, tables, n_dev, src_ids=src_ids)

    state_mh = run_slab_multihost(st, forces, T, p.delta_t,
                                  dtype=jnp.float64, chunk=40)
    mesh_dev = global_device_mesh()
    with mesh_dev as m:
        state_sl = run_slab_solver(st, m, forces, T, p.delta_t,
                                   dtype=jnp.float64, chunk=40)
    u_mh = slab_u_global(st, gather_global(state_mh[0]), mesh.nnum)
    u_sl = slab_u_global(st, np.asarray(state_sl[0]), mesh.nnum)
    np.testing.assert_array_equal(u_mh, u_sl)
    assert np.abs(u_sl).max() > 0


_TWO_PROC_CODE = '''
import os, sys
pid = int(sys.argv[1])
port = sys.argv[2]
outpath = sys.argv[3]
import jax
jax.distributed.initialize(f"127.0.0.1:{port}", num_processes=2,
                           process_id=pid)
print(f"RESULT pid={pid} procs={jax.process_count()} "
      f"devices={len(jax.devices())}", flush=True)
assert jax.process_count() == 2

import numpy as np
import jax.numpy as jnp
from hercules_tpu.config import load_params
from hercules_tpu.cvm import CVM
from hercules_tpu.mesh import Octree, extract_mesh
from hercules_tpu.parallel.multihost import (broadcast_from_host0,
                                             correct_properties_multihost,
                                             gather_global,
                                             run_slab_multihost)
from hercules_tpu.parallel.slab import build_slab_tables, slab_u_global
from hercules_tpu.solver.assemble import assemble

S = "/root/reference/examples/simple"
p = load_params(f"{S}/in/physics.in", f"{S}/in/numerical.in")
cvm = CVM(f"{S}/simple_case.e")
# SHARDED meshing over jax.distributed (mesh/distributed.py): every
# process refines/balances/extracts only its Z-order block — no
# host-0 mesh, no pickle broadcast of MeshArrays
from hercules_tpu.mesh.distributed import (JaxComm, gather_mesh,
                                           generate_mesh_shard)
comm = JaxComm()
assert comm.nproc == 2
shard = generate_mesh_shard(p, cvm, comm)
print(f"SHARD pid={pid} elems={shard.lenum}/{shard.e_global} "
      f"nodes={len(shard.node_x)}/{shard.n_global}", flush=True)
assert shard.lenum < shard.e_global          # really only a block
mesh = gather_mesh(shard, comm)
tables = assemble(mesh, p)
nid = mesh.elem_lnid[mesh.lenum // 2, 0]
src_ids = np.array([nid], np.int32)
T = 60
forces = np.zeros((T, 1, 3)); forces[:10, 0, :] = 1e8
# per-host table build: only this process's device rows
st = build_slab_tables(mesh, tables, 2, src_ids=src_ids,
                       dev_slice=(pid, pid + 1))
assert st.c["c1"].shape[0] == 1 and st.dev0 == pid
state = run_slab_multihost(st, forces, T, p.delta_t,
                           dtype=jnp.float64, chunk=30)
u = slab_u_global(st, gather_global(state[0]), mesh.nnum)
if pid == 0:
    np.save(outpath, u)
print("SOLVED", pid, float(np.abs(u).max()), flush=True)
os._exit(0)
'''


def test_multihost_two_process_slab_solve(tmp_path):
    """A REAL 2-process jax.distributed run of the slab solver: host-0
    meshing + pickle broadcast, per-process shard construction, plane
    halo ppermutes crossing the process boundary; result must equal
    the single-process oracle."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH="/root/repo", JAX_ENABLE_X64="1")
    env.pop("XLA_FLAGS", None)            # 1 device per process
    out = str(tmp_path / "u_mh.npy")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _TWO_PROC_CODE, str(i), "12677", out],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd="/tmp", env=env) for i in range(2)]
    outs = [None, None]

    def wait(i):
        try:
            outs[i] = procs[i].communicate(timeout=240)[0]
        except subprocess.TimeoutExpired:
            procs[i].kill()
            outs[i] = (procs[i].communicate()[0] or "") + "<timeout>"

    ts = [threading.Thread(target=wait, args=(i,)) for i in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    res = [l for o in outs for l in o.splitlines()
           if l.startswith("RESULT")]
    assert len(res) == 2, outs
    if not all("procs=2" in l for l in res):
        pytest.skip("installed jaxlib does not aggregate CPU devices "
                    f"across processes ({res}); validated "
                    "single-process above, runs for real on pods")
    assert all("SOLVED" in o for o in outs), outs
    u_mh = np.load(out)

    # single-process oracle on a 2-device submesh
    from hercules_tpu.parallel.slab import run_slab_solver
    from jax.sharding import Mesh
    p = load_params(f"{SIMPLE}/in/physics.in", f"{SIMPLE}/in/numerical.in")
    cvm = CVM(f"{SIMPLE}/simple_case.e")
    mesh = generate_mesh(p, cvm)
    tables = assemble(mesh, p)
    nid = mesh.elem_lnid[mesh.lenum // 2, 0]
    src_ids = np.array([nid], np.int32)
    T = 60
    forces = np.zeros((T, 1, 3))
    forces[:10, 0, :] = 1e8
    st = build_slab_tables(mesh, tables, 2, src_ids=src_ids)
    with Mesh(np.array(jax.devices()[:2]), ("d",)) as m:
        state = run_slab_solver(st, m, forces, T, p.delta_t,
                                dtype=jnp.float64, chunk=30)
    u_ref = slab_u_global(st, np.asarray(state[0]), mesh.nnum)
    assert np.abs(u_ref).max() > 0
    np.testing.assert_allclose(u_mh, u_ref, rtol=1e-12, atol=1e-18)


_TWO_PROC_SHARD_CODE = '''
import os, sys
pid = int(sys.argv[1])
port = sys.argv[2]
outpath = sys.argv[3]
import jax
jax.distributed.initialize(f"127.0.0.1:{port}", num_processes=2,
                           process_id=pid)
print(f"RESULT pid={pid} procs={jax.process_count()} "
      f"devices={len(jax.devices())}", flush=True)
assert jax.process_count() == 2

import numpy as np
import jax.numpy as jnp
from hercules_tpu.config import load_params
from hercules_tpu.cvm import CVM
import hercules_tpu.mesh.distributed as dist
from hercules_tpu.parallel.multihost import run_slab_multihost
from hercules_tpu.parallel.shardbuild import (attach_sources_shard,
                                              build_slab_tables_shard)

# O(shard) contract: the global mesh must NEVER materialize
def _no_gather(*a, **k):
    raise AssertionError("gather_mesh called on the O(shard) path")
dist.gather_mesh = _no_gather

S = "/root/reference/examples/simple"
p = load_params(f"{S}/in/physics.in", f"{S}/in/numerical.in")
cvm = CVM(f"{S}/simple_case.e")
comm = dist.JaxComm()
shard = generate = dist.generate_mesh_shard(p, cvm, comm)
assert shard.lenum < shard.e_global
st = build_slab_tables_shard(shard, p, comm, 2,
                             dev_slice=(pid, pid + 1))
# structural O(shard) assertions: one stacked device row, no
# global-node-length array anywhere in the tables
assert st.c["c1"].shape[0] == 1 and st.dev0 == pid
N = shard.n_global
for arr in (st.c["c1"], st.inv_mass, st.mass_minusaM):
    assert arr.shape[-1] < N, (arr.shape, N)
src_ids = np.array([shard.elem_lnid[0, 0] if pid == 0 else 0],
                   np.int32)
# both ranks must agree on the source: broadcast via comm
rows = [g for g in comm.allgather_rows(
    np.array([[float(src_ids[0])]]) if pid == 0
    else np.zeros((0, 1)))]
src_ids = np.array([int(r[0, 0]) for r in rows if len(r)], np.int32)
attach_sources_shard(st, shard, src_ids, comm)
T = 60
forces = np.zeros((T, 1, 3)); forces[:10, 0, :] = 1e8
state = run_slab_multihost(st, forces, T, p.delta_t,
                           dtype=jnp.float64, chunk=30)
u_loc = np.asarray(state[0].addressable_shards[0].data)  # [1,3,tot]
g = st.gnid_local[pid]
np.save(outpath + f".{pid}.npy", u_loc[0][:, :len(g)])
np.save(outpath + f".g{pid}.npy", g)
print("SOLVED", pid, float(np.abs(u_loc).max()), flush=True)
os._exit(0)
'''


def test_multihost_two_process_shard_pipeline(tmp_path):
    """The O(shard) pod pipeline for REAL: 2 jax.distributed
    processes mesh their Z-blocks, build slab tables DIRECTLY from
    the shards (gather_mesh monkeypatched to fail), and solve; the
    reassembled field must equal the single-process oracle
    (octor.c:4904-6651 / psolve.c:4705-4863 per-rank memory,
    matched)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH="/root/repo", JAX_ENABLE_X64="1")
    env.pop("XLA_FLAGS", None)
    out = str(tmp_path / "u_shard")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _TWO_PROC_SHARD_CODE, str(i), "12679",
         out],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd="/tmp", env=env) for i in range(2)]
    outs = [None, None]

    def wait(i):
        try:
            outs[i] = procs[i].communicate(timeout=240)[0]
        except subprocess.TimeoutExpired:
            procs[i].kill()
            outs[i] = (procs[i].communicate()[0] or "") + "<timeout>"

    ts = [threading.Thread(target=wait, args=(i,)) for i in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    res = [l for o in outs for l in o.splitlines()
           if l.startswith("RESULT")]
    assert len(res) == 2, outs
    if not all("procs=2" in l for l in res):
        pytest.skip("installed jaxlib does not aggregate CPU devices "
                    f"across processes ({res})")
    assert all("SOLVED" in o for o in outs), outs

    # oracle: single-process slab solve on a 2-device submesh
    from hercules_tpu.parallel.slab import run_slab_solver
    from jax.sharding import Mesh
    p = load_params(f"{SIMPLE}/in/physics.in",
                    f"{SIMPLE}/in/numerical.in")
    cvm = CVM(f"{SIMPLE}/simple_case.e")
    mesh = generate_mesh(p, cvm)
    tables = assemble(mesh, p)
    src_ids = np.array([mesh.elem_lnid[0, 0]], np.int32)
    T = 60
    forces = np.zeros((T, 1, 3))
    forces[:10, 0, :] = 1e8
    st = build_slab_tables(mesh, tables, 2, src_ids=src_ids)
    with Mesh(np.array(jax.devices()[:2]), ("d",)) as m:
        state = run_slab_solver(st, m, forces, T, p.delta_t,
                                dtype=jnp.float64, chunk=30)
    u_ref = slab_u_global(st, np.asarray(state[0]), mesh.nnum)
    assert np.abs(u_ref).max() > 0

    u_mh = np.zeros_like(u_ref)
    for pid in range(2):
        u = np.load(out + f".{pid}.npy")
        g = np.load(out + f".g{pid}.npy")
        u_mh[g] = u.T
    # 2-process gloo collectives vs the single-process 2-device
    # oracle: identical tables (test_shardbuild proves bitwise
    # equality), ulp-level reduction-order differences in the halo
    # adds — same tolerance as the gather-based two-process test
    np.testing.assert_allclose(u_mh, u_ref, rtol=1e-12, atol=1e-18)

