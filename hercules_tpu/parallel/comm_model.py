"""Per-step communication model for the multi-chip solver paths.

The reference exchanges halos with four index-mapped MPI sends per
timestep (schedule_senddata, psolve.c:4946-5079) and publishes no
model of the traffic.  Here every path's per-step exchange is a small
set of static-shape collectives, so the volume is exactly computable
from the partition tables -- this module derives it and turns it into
a scaling projection (compute time from a measured single-card rate,
communication time from the card's published link rate).  A projection
is never a measurement: collective times come from a profiler trace.

Byte counts are per device per step, counting bytes *sent* (links are
full duplex; the symmetric receive rides the opposite direction):

- slab (parallel/slab.py): two ppermutes of one [3, nyp*nxp] force
  plane each (up and down neighbors).
- sharded (parallel/sharded.py): one psum over the [B_pad, 3]
  shared-node boundary buffer; a ring all-reduce moves
  2*(n-1)/n * B_pad*3 values per device in 2*(n-1) latency phases.

The model is validated against the implementations by tracing one
step with recording shims around jax.lax.ppermute/psum
(tests/test_comm_model.py), so it cannot drift from the code.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class HwModel:
    name: str
    hbm_gbps: float          # device memory bandwidth, GB/s
    link_gbps: float         # one-way card-to-card bandwidth, GB/s
    phase_latency_us: float  # per collective phase (assumed, see below)


# Published per-card figures, keyed by jax's device_kind.  Source:
# NVIDIA H100 Tensor Core GPU data sheet, SXM part: 3.35 TB/s HBM3,
# 900 GB/s NVLink (450 GB/s each way), all-to-all inside a host.  No
# per-phase collective latency is published; 5 us is an assumption to
# be replaced by a trace measurement.
HARDWARE = {
    "NVIDIA H100 80GB HBM3": HwModel("H100 SXM", hbm_gbps=3350.0,
                                     link_gbps=450.0,
                                     phase_latency_us=5.0),
}


def hw_model(device_kind: str) -> HwModel:
    """The table entry for a device kind; an unknown device is an
    error, not a default."""
    try:
        return HARDWARE[device_kind]
    except KeyError:
        raise ValueError(
            f"no published link/memory figures for device kind "
            f"{device_kind!r}; add it to comm_model.HARDWARE") from None


@dataclass
class PathComm:
    """Per-step communication of one solver path at one device count."""
    path: str
    n_dev: int
    bytes_out: int           # bytes sent per device per step (max dev)
    phases: int              # dependent collective phases (latency)
    detail: dict = field(default_factory=dict)


def slab_comm(st, dtype_bytes=4) -> PathComm:
    """Exchange volume of the uniform-brick z-slab path.

    Two ppermutes of a [3, plane] force plane (slab.py:260-265 and
    the fused variant slab.py:460-464)."""
    plane = st.nyp * st.nxp
    b = 2 * 3 * plane * dtype_bytes
    return PathComm("slab", st.n_dev, b, phases=2,
                    detail={"plane": plane})


def sharded_comm(st, dtype_bytes=None) -> PathComm:
    """Exchange volume of the unstructured sharded path.

    One psum over the [B_pad, 3] boundary buffer (sharded.py:190-192).
    Ring all-reduce: 2*(n-1)/n * payload bytes per device, 2*(n-1)
    phases."""
    n = st.n_dev
    B_pad = int(st.b_lidx.shape[1])
    if dtype_bytes is None:
        dtype_bytes = 4
    payload = B_pad * 3 * dtype_bytes
    b = int(2 * (n - 1) / n * payload)
    return PathComm("sharded", n, b, phases=2 * (n - 1),
                    detail={"B_pad": B_pad, "payload": payload})


def predict(comm: PathComm, n_elem: int, eups_1chip: float,
            hw: HwModel) -> dict:
    """Scaling projection for one path/device count.

    t_compute from the measured single-card element rate (it scales
    with the local element count); t_comm = phases * latency + bytes /
    link rate.  The collectives
    sit on the critical path inside the scanned step (the force
    exchange feeds the node update), so the serialized sum is the
    honest bound; the overlap column shows the ceiling if a future
    kernel hides the exchange behind compute."""
    t_compute = n_elem / comm.n_dev / eups_1chip
    t_comm = (comm.phases * hw.phase_latency_us * 1e-6
              + comm.bytes_out / (hw.link_gbps * 1e9))
    t_serial = t_compute + t_comm
    t_overlap = max(t_compute, t_comm)
    return {
        "path": comm.path,
        "n_dev": comm.n_dev,
        "bytes_out_per_dev": comm.bytes_out,
        "phases": comm.phases,
        "t_compute_s": t_compute,
        "t_comm_s": t_comm,
        "t_step_s": t_serial,
        "t_step_overlap_s": t_overlap,
        "eups": n_elem / t_serial,
        "efficiency": t_compute / t_serial,
        "detail": comm.detail,
    }


def slab_comm_dims(nxp, nyp, n_dev, dtype_bytes=4) -> PathComm:
    """slab_comm from raw node-grid dims (no tables needed): lets the
    report project device counts beyond the built table."""
    plane = nyp * nxp
    return PathComm("slab", n_dev, 2 * 3 * plane * dtype_bytes,
                    phases=2, detail={"plane": plane})


def scaling_report(nxp, nyp, nzp, n_elem, eups_1chip, hw: HwModel,
                   device_counts=(1, 2, 4, 8, 16, 32, 64, 128, 256)) -> str:
    """Text table: projected slab-path scaling over a device ring.

    The z-slab split caps useful devices at nzp-1 element layers; rows
    beyond that are marked.  Communication per device is *constant* in
    n (two fixed planes), so slab scaling is latency/bandwidth-flat
    and efficiency falls only as local compute shrinks toward t_comm.
    """
    lines = [
        f"# comm model (projection, not a measurement): {hw.name} "
        f"(link {hw.link_gbps:.0f} GB/s each way, "
        f"{hw.phase_latency_us:.1f} us/phase assumed); "
        f"mesh {nxp-1}x{nyp-1}x{nzp-1} elem = {n_elem:.3e}, "
        f"measured {eups_1chip:.3e} eups/card",
        "# ndev  bytes/dev/step  t_comp(us)  t_comm(us)  t_step(us)"
        "   eups         eff",
    ]
    nz_elem = nzp - 1
    for n in device_counts:
        if n > nz_elem:
            lines.append(f"# {n:5d}  -- exceeds {nz_elem} z element "
                         f"layers (slab split cap)")
            continue
        c = (PathComm("slab", 1, 0, 0) if n == 1
             else slab_comm_dims(nxp, nyp, n))
        r = predict(c, n_elem, eups_1chip, hw)
        lines.append(
            f"# {n:5d}  {r['bytes_out_per_dev']:>14,}  "
            f"{r['t_compute_s']*1e6:10.1f}  {r['t_comm_s']*1e6:10.1f}  "
            f"{r['t_step_s']*1e6:10.1f}   {r['eups']:.3e}  "
            f"{r['efficiency']*100:5.1f}%")
    return "\n".join(lines)
