"""psolve-compatible command line entry.

Usage (both reference forms accepted):
  python -m hercules_tpu.cli <parameters.in>
  python -m hercules_tpu.cli <cvmdb> <physics.in> <numerical.in> \
      [mesh.e out.q4d]     (the legacy quake.sh argument order)

Options:
  --ndev=N|auto|1   device count for the multi-chip pipeline
                    (default auto: every visible device, like psolve
                    uses every MPI rank; 1 forces single-device)
  --mc-path=NAME    force a parallel path (slab, sharded)
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np


def _looks_like_database(path):
    """Is the first positional argument a material database (etree /
    flat records) rather than a config file?  Name-only sniffing
    misparses a physics file named e.g. `params.txt` as a database, so
    decide by CONTENT: config files are text key=value, databases are
    binary (NUL bytes / non-UTF8 in the first block)."""
    if path.endswith(".e"):
        return True
    if path.endswith(".in") or not os.path.exists(path):
        return False
    try:
        with open(path, "rb") as f:
            head = f.read(512)
    except OSError:
        return False
    if b"\0" in head:
        return True
    try:
        head.decode("utf-8")
    except UnicodeDecodeError:
        return True
    return False


def main(argv=None):
    return run(argv)[0]


def run(argv=None):
    """The hpsolve run; returns (exit code, Simulation or None)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    ndev_opt = "auto"
    mc_path = None
    rest = []
    for a in argv:
        if a.startswith("--ndev="):
            ndev_opt = a.split("=", 1)[1]
        elif a.startswith("--mc-path="):
            mc_path = a.split("=", 1)[1]
        else:
            rest.append(a)
    argv = rest
    if not argv:
        print(__doc__)
        return 2, None

    cvmdb = None
    mesh_out = None
    if len(argv) == 1:
        physics_in = numerical_in = argv[0]
    elif len(argv) >= 3 and _looks_like_database(argv[0]):
        cvmdb, physics_in, numerical_in = argv[0], argv[1], argv[2]
        if len(argv) > 3:
            mesh_out = argv[3]
    else:
        physics_in = argv[0]
        numerical_in = argv[1] if len(argv) > 1 else argv[0]

    import jax
    from .utils.compile_cache import setup_compile_cache
    setup_compile_cache()
    if jax.default_backend() == "cpu":
        jax.config.update("jax_enable_x64", True)

    from .sim import Simulation, write_station_files
    from .io.monitor import Monitor
    from .utils.timers import GLOBAL_TIMERS, print_timing_stat

    t0 = time.time()
    GLOBAL_TIMERS.start("Total Wall Clock")
    sim = Simulation.setup(physics_in, numerical_in, cvmdb=cvmdb,
                           verbose=True)
    p = sim.params
    mpath = p.monitor_file
    rundir0 = os.path.dirname(os.path.dirname(
        os.path.abspath(physics_in))) or "."
    if mpath and not os.path.isabs(mpath):
        mpath = os.path.join(rundir0, mpath)
    mon = Monitor(mpath)
    mon.print(f"mesh_generate + solver_init: {time.time()-t0:.1f} s\n")
    mon.print(f"Total elements: {sim.mesh.lenum}\n"
              f"Total nodes: {sim.mesh.nnum}\n"
              f"Total dangling nodes: {len(sim.mesh.dn_ids)}\n")

    import io as _io
    with GLOBAL_TIMERS.measure("Mesh Stats Print"):
        from .utils.stats import mesh_stats
        buf = _io.StringIO()
        mesh_stats(sim.mesh, out=buf)
        mon.print(buf.getvalue())
        if p.stat_mesh_filename:
            path = p.stat_mesh_filename
            if not os.path.isabs(path):
                path = os.path.join(rundir0, path)
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with open(path, "w") as f:
                f.write(buf.getvalue())

    if p.print_matrix_k:
        # print_K_stdoutput (psolve.c:3184)
        from .utils.stats import print_k_matrices
        print_k_matrices()

    if (p.schedule_print_file or p.schedule_print_stdout
            or p.schedule_print_error_check):
        from .utils.stats import schedule_stats
        plan = None
        try:
            from .solver.bricks import build_plan
            plan = build_plan(sim.mesh)
        except RuntimeError:
            pass
        buf = _io.StringIO()
        schedule_stats(sim.mesh, plan, out=buf,
                       error_check=bool(p.schedule_print_error_check))
        if p.schedule_print_stdout:
            sys.stdout.write(buf.getvalue())
        if p.schedule_print_file:
            path = p.stat_schedule_filename
            if not os.path.isabs(path):
                path = os.path.join(rundir0, path)
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with open(path, "w") as f:
                f.write(buf.getvalue())

    if os.environ.get("IO_PES"):
        # the reference splits IO-server ranks off comm_solver
        # (psolve.c:7360-7389); here output overlap comes from the
        # async writer threads, so the env var is a no-op
        mon.print("IO_PES set: async writer threads subsume the "
                  "reference's IO pool; no ranks reserved\n")

    if p.damping_statistics:
        from .utils.stats import critical_t_stats, damping_histograms
        import io as _io
        buf = _io.StringIO()
        critical_t_stats(sim.mesh, p, out=buf)
        damping_histograms(sim.mesh, p, out=buf)
        mon.print(buf.getvalue())

    if p.mesh_coordinates_for_matlab.lower() == "yes":
        # saveMeshCoordinatesForMatlab (meshformatlab.c:30-250):
        # corners list bounds the dumped region (xmin ymin xmax ymax
        # zmin zmax in meters); whole domain when absent
        from .io.matlab import write_matlab_mesh
        mdir = p.mesh_coordinates_directory_for_matlab or "matlab"
        if not os.path.isabs(mdir):
            mdir = os.path.join(rundir0, mdir)
        bbox = None
        if p.mesh_corners_matlab is not None:
            c = p.mesh_corners_matlab
            bbox = (c[0], c[2], c[1], c[3], c[4], c[5])
        nml = write_matlab_mesh(mdir, sim.mesh, p, bbox=bbox)
        mon.print(f"matlab mesh coordinates written: {mdir} "
                  f"({nml} elements)\n")

    if p.output_mesh and (mesh_out or p.mesh_etree_output_file):
        from .io.meshout import write_mesh_etree
        path = mesh_out or p.mesh_etree_output_file
        if not os.path.isabs(path):
            path = os.path.join(rundir0, path)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        write_mesh_etree(path, sim.mesh)
        mon.print(f"mesh database written: {path}\n")

    t1 = time.time()
    mon.print(f"solver_run() start: {p.total_steps} steps\n")

    def on_chunk(done, state):
        el = time.time() - t1
        eta = el / done * (p.total_steps - done)
        mon.print(f"step {done:8d}/{p.total_steps}  "
                  f"wall {el:8.1f}s  ETA {eta:8.1f}s\n")

    from .sim import SimOutputs
    rundir = rundir0
    outputs = SimOutputs(sim.mesh, p, rundir=rundir)
    # multi-chip by default: every visible device, as psolve uses
    # every MPI rank (HT_NDEV / --ndev=1 force single-device)
    if ndev_opt == "auto":
        ndev = jax.device_count()
    else:
        ndev = int(ndev_opt)
    if ndev > 1:
        mon.print(f"multi-chip pipeline: {ndev} devices\n")
    GLOBAL_TIMERS.start("Solver")
    state, samples = sim.run(on_chunk=on_chunk, outputs=outputs,
                             rundir=rundir, ndev=ndev, mc_path=mc_path)
    GLOBAL_TIMERS.stop("Solver")
    el = time.time() - t1
    # path provenance + step rate in the monitor, so a silent
    # fallback-chain degradation is always visible in the run record
    # (the reference's monitor/timing discipline, psolve.c:3810-3840)
    done_steps = max(p.total_steps - getattr(sim, "start_step", 0), 1)
    mon.print(f"solver path: {sim.solver_path_name or 'unknown'}  "
              f"({done_steps / max(el, 1e-9):.1f} steps/s)\n")
    mon.print(f"solver_run done: {el:.1f} s\n")

    if sim.stations is not None:
        outdir = p.stations_dir or "stations"
        if not os.path.isabs(outdir):
            outdir = os.path.join(rundir, outdir)
        write_station_files(outdir, sim.stations, samples, p.delta_t,
                            print_rate=p.stations_print_rate,
                            velocities=bool(p.print_station_velocities),
                            accelerations=bool(
                                p.print_station_accelerations),
                            start_step=getattr(sim, "start_step", 0),
                            nl_extras=getattr(sim, "nl_station_extras",
                                              None) or None)
        mon.print(f"station files written: {outdir}\n")

    GLOBAL_TIMERS.stop("Total Wall Clock")
    from .physics.consts import critical_dt
    import io as _io
    buf = _io.StringIO()
    print_timing_stat(p, sim.mesh, out=buf,
                      critical_t=critical_dt(sim.mesh.props,
                                             sim.mesh.edge_m))
    mon.print(buf.getvalue())
    return 0, sim


if __name__ == "__main__":
    sys.exit(main())
