"""The comm model (parallel/comm_model.py) must match the traffic the
implementations actually emit: trace one step of each multi-chip path
with recording shims around jax.lax.ppermute / jax.lax.psum and compare
recorded per-device sent bytes and phase counts against the model."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from hercules_tpu.config import load_params
from hercules_tpu.cvm import CVM
from hercules_tpu.meshgen import generate_mesh
from hercules_tpu.parallel.comm_model import (hw_model, predict,
                                              scaling_report,
                                              sharded_comm, slab_comm)
from hercules_tpu.solver.assemble import assemble

SIMPLE = "/root/reference/examples/simple"


class Recorder:
    """Swap jax.lax.ppermute/psum for shims that log static shapes."""

    def __init__(self, monkeypatch):
        self.ppermutes = []   # (nbytes_per_shard, perm)
        self.psums = []       # nbytes_per_shard
        real_pp, real_ps = jax.lax.ppermute, jax.lax.psum

        def pp(x, axis_name, perm):
            self.ppermutes.append(
                (x.size * x.dtype.itemsize, list(perm)))
            return real_pp(x, axis_name, perm)

        def ps(x, axis_name, **kw):
            if hasattr(x, "size"):  # ignore python-scalar reductions
                self.psums.append(x.size * x.dtype.itemsize)
            return real_ps(x, axis_name, **kw)

        monkeypatch.setattr(jax.lax, "ppermute", pp)
        monkeypatch.setattr(jax.lax, "psum", ps)

    def sent_bytes(self, n_dev):
        """Per-device bytes sent through ppermutes (a device sends its
        shard iff it appears as a source in the perm)."""
        out = [0] * n_dev
        phases = [0] * n_dev
        for nbytes, perm in self.ppermutes:
            for src, _dst in perm:
                out[src] += nbytes
                phases[src] += 1
        return out, phases


def _simple_mesh():
    p = load_params(f"{SIMPLE}/in/physics.in",
                    f"{SIMPLE}/in/numerical.in")
    cvm = CVM(f"{SIMPLE}/simple_case.e")
    mesh = generate_mesh(p, cvm)
    return p, mesh, assemble(mesh, p)


def test_slab_comm_matches_trace(monkeypatch):
    from hercules_tpu.parallel.slab import (build_slab_tables,
                                            run_slab_solver)
    p, mesh, tables = _simple_mesh()
    nid = np.array([mesh.elem_lnid[mesh.lenum // 2, 0]], np.int32)
    st = build_slab_tables(mesh, tables, 4, src_ids=nid)
    model = slab_comm(st)

    rec = Recorder(monkeypatch)
    devs = np.array(jax.devices()[:4])
    forces = np.zeros((1, 1, 3))
    with Mesh(devs, ("d",)) as m:
        run_slab_solver(st, m, forces, 1, p.delta_t,
                        dtype=jnp.float32, chunk=1)
    sent, phases = rec.sent_bytes(4)
    # full-ring ppermutes: every device sends both planes every step
    assert max(sent) == model.bytes_out
    assert max(phases) == model.phases
    assert min(sent) == model.bytes_out  # uniform ring


def test_sharded_comm_matches_trace(monkeypatch):
    from hercules_tpu.parallel.partition import shard_tables
    from hercules_tpu.parallel.sharded import run_sharded
    p, mesh, tables = _simple_mesh()
    nid = np.array([mesh.elem_lnid[mesh.lenum // 2, 0]], np.int32)
    st = shard_tables(tables, mesh, 4, src_ids=nid)
    model = sharded_comm(st)

    rec = Recorder(monkeypatch)
    devs = np.array(jax.devices()[:4])
    forces = np.zeros((1, 1, 3))
    with Mesh(devs, ("d",)) as m:
        run_sharded(st, m, forces, 1, p.delta_t, dtype=jnp.float32)
    # one boundary psum of the [B_pad, 3] buffer per step
    assert model.detail["payload"] in rec.psums
    # ring all-reduce volume formula
    assert model.bytes_out == int(2 * 3 / 4 * model.detail["payload"])


def test_predict_and_report_shape():
    from hercules_tpu.parallel.comm_model import slab_comm_dims
    hw = hw_model("NVIDIA H100 80GB HBM3")
    c = slab_comm_dims(601, 301, 8)
    r = predict(c, 11.3e6, 4.0e8, hw)
    assert 0 < r["efficiency"] <= 1
    assert r["t_step_s"] >= r["t_step_overlap_s"]
    # constant per-device comm: doubling devices halves compute only
    r16 = predict(slab_comm_dims(601, 301, 16), 11.3e6, 4.0e8, hw)
    assert r16["t_comm_s"] == r["t_comm_s"]
    assert r16["t_compute_s"] < r["t_compute_s"]
    txt = scaling_report(601, 301, 85, 11.3e6, 4.0e8, hw)
    assert "eups" in txt and "256" in txt and "not a measurement" in txt


def test_hw_model_rejects_unknown_device():
    with pytest.raises(ValueError, match="no published"):
        hw_model("Unlisted Accelerator 1")

