"""End-to-end simulation pipeline: the psolve main() equivalent
(psolve.c:7335-7568) — config, CVM, meshing, solver setup, source,
stations, time loop, outputs."""

from __future__ import annotations

import os
import sys
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np

from .config import Params, load_params
from .cvm import CVM, open_material_db
from .meshgen import generate_mesh
from .mesh.locate import locate_points, local_coords
from .physics.consts import critical_dt
from .solver.assemble import assemble
from .solver.step import run_solver
from .source.model import SourceModel, compute_domain_coords_linearinterp

XI = np.array([
    [-1, 1, -1, 1, -1, 1, -1, 1],
    [-1, -1, 1, 1, -1, -1, 1, 1],
    [-1, -1, -1, -1, 1, 1, 1, 1],
], dtype=np.float64)


@dataclass
class StationSet:
    ids: np.ndarray          # [S] original station indices
    nodes: np.ndarray        # [S, 8] node ids to interpolate
    phi: np.ndarray          # [S, 8] trilinear weights
    coords: np.ndarray       # [S, 3] domain coords
    eidx: np.ndarray = None  # [S] containing element indices


def _rebuild_brick_conv(plan, flat, dtype):
    """Re-nest flattened BKT convolution arrays from a checkpoint into
    the brick-step carry structure (4 per brick, then 4 for the loose
    elements when present)."""
    import jax.numpy as jnp
    out = []
    i = 0
    for _ in plan.bricks:
        out.append(tuple(jnp.asarray(flat[i + k], dtype)
                         for k in range(4)))
        i += 4
    if len(plan.loose_eidx):
        out.append(tuple(jnp.asarray(flat[i + k], dtype)
                         for k in range(4)))
        i += 4
    assert i == len(flat), "checkpoint BKT state does not match plan"
    return tuple(out)


def setup_stations(mesh, params: Params) -> Optional[StationSet]:
    """read_stations_info + setup_stations_data (psolve.c:6447-6673):
    lat/lon -> domain coords via the surface-corner bilinear map, element
    search, local coords, phi weights."""
    if not params.number_output_stations or params.stations is None:
        return None
    lat = params.stations[:, 0]
    lon = params.stations[:, 1]
    depth = params.stations[:, 2].copy()
    if mesh.buildings is not None:
        depth = depth + mesh.buildings.surface_shift
    x, y = compute_domain_coords_linearinterp(
        lon, lat, params.domain_surface_corners[:, 0],
        params.domain_surface_corners[:, 1],
        params.region_length_east_m, params.region_length_north_m)
    found, eidx = locate_points(mesh, x, y, depth)
    keep = np.flatnonzero(found)
    if len(keep) == 0:
        return None
    eidx = eidx[keep]
    cx, cy, cz = local_coords(mesh, eidx, x[keep], y[keep], depth[keep])
    phi = ((1 + XI[0][None, :] * cx[:, None])
           * (1 + XI[1][None, :] * cy[:, None])
           * (1 + XI[2][None, :] * cz[:, None]) / 8.0)
    return StationSet(ids=keep.astype(np.int32),
                      nodes=mesh.elem_lnid[eidx],
                      phi=phi,
                      coords=np.stack([x[keep], y[keep], depth[keep]], 1),
                      eidx=eidx)


def write_station_files(outdir, stations: StationSet, samples, dt,
                        print_rate=1, velocities=False,
                        accelerations=False, start_step=0,
                        nl_extras=None):
    """Reference station text format (psolve.c:6636-6795): header line
    then time + displacement per step, with optional velocity and
    acceleration columns.

    The reference computes v = (tm1 - tm2)/dt and a = (tm1 - 2 tm2 +
    tm3)/dt^2 in-loop; since row s holds u(s), the same finite
    differences apply to the recorded series.

    start_step > 0 (checkpoint restart): samples[0] is the field at
    `start_step`; rows are appended to the existing files on the
    absolute print_rate grid.

    nl_extras: {station id: [T, 17]} nonlinear strain/stress columns
    (print_nonlinear_stations, nonlinear.c:2078-2228)."""
    os.makedirs(outdir, exist_ok=True)
    T = samples.shape[0]
    if accelerations:
        velocities = True
    a0 = ((start_step + print_rate - 1) // print_rate) * print_rate
    for k, sid in enumerate(stations.ids):
        path = os.path.join(outdir, f"station.{int(sid)}")
        extra = None if nl_extras is None else nl_extras.get(int(sid))
        with open(path, "a" if start_step else "w") as f:
            if not start_step:
                f.write("#  Time(s)         X|(m)         Y-(m)"
                        "         Z.(m)")
                if velocities:
                    f.write("       X|(m/s)       Y-(m/s)       Z.(m/s)")
                if accelerations:
                    f.write("      X|(m/s2)      Y-(m/s2)      Z.(m/s2)")
                if extra is not None:
                    from .nonlinear import NL_STATION_HEADER
                    f.write(NL_STATION_HEADER)
            u = samples[:, k, :]

            def at(s):
                return u[s] if s >= 0 else np.zeros(3)

            for ab in range(a0, start_step + T, print_rate):
                s = ab - start_step
                t = dt * ab
                f.write("\n%10.6f % 8e % 8e % 8e"
                        % (t, u[s, 0], u[s, 1], u[s, 2]))
                if velocities:
                    v = (u[s] - at(s - 1)) / dt
                    f.write(" % 8e % 8e % 8e" % (v[0], v[1], v[2]))
                if accelerations:
                    a = (u[s] - 2 * at(s - 1) + at(s - 2)) / (dt * dt)
                    f.write(" % 8e % 8e % 8e" % (a[0], a[1], a[2]))
                if extra is not None:
                    f.write("".join(" % 8e" % v for v in extra[s]))
            f.write("\n")


class SimOutputs:
    """Per-run output taps: 4-D volume files, plane files, checkpoints.

    The solver runs in chunks whose size divides every active rate, so
    each tap fires exactly on its rate boundary with the state at that
    step (the reference taps at loop top with the displacement of the
    previous update — equivalent at rate boundaries)."""

    def __init__(self, mesh, params, rundir="."):
        import math
        self.mesh = mesh
        self.params = params
        self._rundir = rundir
        self.out4d = []
        self.planes = None
        self.ckpt_dir = None
        rates = []
        p = params

        def absdir(d):
            return d if os.path.isabs(d) else os.path.join(rundir, d)

        if p.output_displacement or p.output_velocity:
            from .io.output4d import Output4D
            if p.output_displacement:
                path = absdir(p.output_displacement_file)
                os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
                self.out4d.append(("displacement",
                                   Output4D(path, mesh, p,
                                            "displacement")))
            if p.output_velocity:
                path = absdir(p.output_velocity_file)
                os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
                self.out4d.append(("velocity",
                                   Output4D(path, mesh, p, "velocity")))
            rates.append(p.output_rate)
        if p.number_output_planes:
            from .io.planes import PlaneSet
            self.planes = PlaneSet(mesh, p, absdir(p.planes_dir or
                                                   "planes"))
            rates.append(p.planes_print_rate)
        self.ck_rate = 0
        if p.use_checkpoint and p.checkpointing_rate:
            self.ckpt_dir = absdir(p.checkpoint_path or "checkpoints")
            self.ck_rate = p.checkpointing_rate
            rates.append(p.checkpointing_rate)
        self.rates = rates
        self.active = bool(rates)
        self._gcd = math.gcd(*rates) if rates else 0
        # snapshot taps (4-D volume + planes, which need only u/up)
        # ride the scan as rate-strided emissions so the dispatch size
        # stays large; checkpoints (which need the full carry) fire at
        # chunk boundaries.  Falls back to gcd-sized chunks when the
        # checkpoint rate is incommensurate with the snapshot stride.
        snap_rates = [r for r in rates if r != self.ck_rate] \
            if self.ck_rate else list(rates)
        self.snap_every = math.gcd(*snap_rates) if snap_rates else 0
        if (self.snap_every and self.ck_rate
                and self.ck_rate % self.snap_every != 0):
            self.snap_every = 0

    def chunk_for(self, desired=1000):
        """Dispatch size: large, but landing on every checkpoint
        boundary; snapshot taps are emitted from inside the scan."""
        if not self.active:
            return desired
        if self.snap_every:
            # bound the on-device snapshot stack (~256 MB)
            snap_bytes = 2 * 3 * self.mesh.nnum * 8
            kmax = max(1, int(268_435_456 // snap_bytes))
            c = max(self.snap_every,
                    min(desired, self.snap_every * kmax)
                    // self.snap_every * self.snap_every)
            if self.ck_rate:
                m = self.ck_rate // self.snap_every
                best = 1
                for d in range(1, m + 1):
                    if m % d == 0 and self.snap_every * d <= c:
                        best = d
                c = self.snap_every * best
            return c
        g = self._gcd
        return desired if g <= 0 else g

    def make_hook(self, mesh, plan, inner=None, start_step=0):
        gnid_cat = plan.gnid_cat if plan is not None else None

        def slot_global(u):
            u = np.asarray(u)
            if gnid_cat is not None:          # brick layout [3, TOT]
                out = np.zeros((mesh.nnum, 3), u.dtype)
                out[gnid_cat] = u[:, :len(gnid_cat)].T
                return out
            return u                          # unstructured [N, 3]

        def carry_slots(state):
            """(u_slot, up_slot, tail) of a solver carry."""
            return state[0], state[1], tuple(state[2:])

        def u_global(state):
            return slot_global(carry_slots(state)[0])

        def u_prev_global(state):
            return slot_global(carry_slots(state)[1])

        p = self.params

        # step-0 records (the reference's loop-top output of the zero
        # initial field); skipped on checkpoint restart
        if start_step == 0:
            zero = np.zeros((mesh.nnum, 3))
            for kind, w in self.out4d:
                w.maybe_write(0, zero)
            if self.planes is not None:
                self.planes.maybe_write(
                    0, lambda nodes, phi: np.zeros((len(nodes), 3)))

        def snap_taps(done, state):
            """4-D volume + plane taps from a (u, up) pair."""
            ug = None
            for kind, w in self.out4d:
                if done % w.rate == 0 and done // w.rate < w.out_steps:
                    ug = u_global(state) if ug is None else ug
                    if kind == "displacement":
                        w.maybe_write(done, ug)
                    else:
                        up = u_prev_global(state)
                        w.maybe_write(done, (ug - up) / p.delta_t)
            if (self.planes is not None and done < p.total_steps
                    and done % p.planes_print_rate == 0):
                ug = u_global(state) if ug is None else ug

                def sampler(nodes, phi, _u=ug):
                    return np.einsum("mk,mkc->mc", phi, _u[nodes])

                self.planes.maybe_write(done, sampler)

        snap_split = self.snap_every > 0

        def hook(done, state):
            if not snap_split:
                snap_taps(done, state)
            if (self.ckpt_dir is not None
                    and done % p.checkpointing_rate == 0):
                from .io.checkpoint import checkpoint_write_async
                # the whole carry tail (BKT convolution and nonlinear
                # state) goes into the checkpoint -- the reference only
                # saves tm1/tm2 (io_checkpoint.c:29-134), a known
                # restart-semantics gap this fixes
                u0, u1, tail = carry_slots(state)
                # record the run's damping model and nonlinear
                # presence so a restart under different physics fails
                # loudly instead of misassigning the state arrays
                checkpoint_write_async(
                    self.ckpt_dir, done, (u0, u1, tail),
                    extra={"damping": np.asarray(p.type_of_damping),
                           "has_nl": np.asarray(
                               bool(p.include_nonlinear))})
            if inner is not None:
                inner(done, state)

        return hook, (snap_taps if snap_split else None)

    def make_mc_hook(self, path, inner=None, start_step=0):
        """Multi-chip variant of make_hook: taps receive lazy global
        [N,3] field getters assembled by the parallel path adapter
        (parallel/driver.py), and checkpoints save the path-shaped
        carry tail with enough metadata to validate a resume."""
        p = self.params

        if start_step == 0:
            zero = np.zeros((self.mesh.nnum, 3))
            for kind, w in self.out4d:
                w.maybe_write(0, zero)
            if self.planes is not None:
                self.planes.maybe_write(
                    0, lambda nodes, phi: np.zeros((len(nodes), 3)))

        def snap_taps(done, uget, upget):
            for kind, w in self.out4d:
                if done % w.rate == 0 and done // w.rate < w.out_steps:
                    if kind == "displacement":
                        w.maybe_write(done, uget())
                    else:
                        w.maybe_write(done,
                                      (uget() - upget()) / p.delta_t)
            if (self.planes is not None and done < p.total_steps
                    and done % p.planes_print_rate == 0):
                ug = uget()

                def sampler(nodes, phi, _u=ug):
                    return np.einsum("mk,mkc->mc", phi, _u[nodes])

                self.planes.maybe_write(done, sampler)

        snap_split = self.snap_every > 0

        def hook(done, state):
            if not snap_split:
                memo = {}
                snap_taps(
                    done,
                    lambda: memo.setdefault("u", path.u_global(state)),
                    lambda: memo.setdefault("up",
                                            path.up_global(state)))
            if (self.ckpt_dir is not None
                    and done % p.checkpointing_rate == 0):
                from .io.checkpoint import checkpoint_write_async
                u0 = path.u_global(state)
                u1 = path.up_global(state)
                checkpoint_write_async(
                    self.ckpt_dir, done, (u0, u1, path.tail(state)),
                    extra={"damping": np.asarray(p.type_of_damping),
                           "has_nl": np.asarray(
                               bool(p.include_nonlinear)),
                           "mc_path": np.asarray(path.name),
                           "mc_ndev": np.asarray(path.n_dev)})
            if inner is not None:
                inner(done, state)

        return hook, (snap_taps if snap_split else None)

    def close(self):
        if self.ckpt_dir is not None:
            from .io.checkpoint import checkpoint_flush
            checkpoint_flush()
        for _, w in self.out4d:
            w.close()
        if self.out4d and self.params.output_stats_file:
            path = self.params.output_stats_file
            if not os.path.isabs(path):
                path = os.path.join(self._rundir, path)
            self.out4d[0][1].write_stats(path)
        if self.planes is not None:
            self.planes.close()


@dataclass
class Simulation:
    params: Params
    cvm: CVM
    mesh: object
    tables: object
    source: SourceModel
    src_ids: np.ndarray
    src_forces: np.ndarray
    stations: Optional[StationSet]
    nl_tables: object = None
    drm_plan: object = None
    drm_dir: str = ""
    # provenance: which solver path actually ran the last .run()
    # ("bricks", "unstructured", "mc:<path>"), recorded for
    # monitor.txt and the benchmark output (psolve's monitor
    # discipline, psolve.c:3810-3840)
    solver_path_name: str = ""
    # host set-up seconds by phase ("mesh", "assemble")
    timings: dict = None

    @classmethod
    def setup(cls, physics_in, numerical_in=None, cvmdb=None,
              verbose=False):
        params = load_params(physics_in, numerical_in)
        rundir = os.path.dirname(os.path.dirname(
            os.path.abspath(physics_in))) or "."
        if cvmdb is None:
            cvmdb = params.cvmdb_input_file
            if cvmdb and not os.path.isabs(cvmdb):
                cvmdb = os.path.join(rundir, cvmdb)
        cvm = open_material_db(cvmdb, params)
        buildings = None
        if params.include_buildings:
            from .buildings import Buildings
            from .config import ConfigFile
            buildings = Buildings.parse(ConfigFile(params.numerical_path))
        t0 = time.perf_counter()
        mesh = generate_mesh(params, cvm, buildings=buildings,
                             verbose=verbose)
        t_mesh = time.perf_counter() - t0
        from .physics.consts import critical_dt_factors
        tcrit = critical_dt(mesh.props, mesh.edge_m)
        _, dt_x, dt_z = critical_dt_factors(mesh.props, mesh.edge_m,
                                            params)
        tstab = min(dt_x, dt_z)
        if verbose:
            print(f"mesh: {mesh.lenum} elements, {mesh.nnum} nodes, "
                  f"{len(mesh.dn_ids)} dangling; "
                  f"critical dt {tcrit:.6f} (damped stability bound "
                  f"{tstab:.6f})")
        if getattr(params, "auto_delta_t", 0):
            # AUTO_DELTA_T (psolve.c:3033-3040): override delta_t with
            # theCriticalT and recompute the step count
            params.delta_t = tcrit
            params.total_steps = int(
                (params.end_time - params.start_time) / params.delta_t)
            if verbose:
                print(f"AUTO_DELTA_T: delta_t = {tcrit:.6g}, "
                      f"{params.total_steps} steps")
        elif params.delta_t > tstab:
            # solver_set_critical_T stability check with the
            # reference-exact 0.577(1-xi)h/Vp factors
            # (psolve.c:2864-2872)
            print(f"WARNING: delta_t {params.delta_t:g} exceeds the "
                  f"damped stability bound {tstab:g} "
                  f"(min dt_X {dt_x:g}, min dt_Z {dt_z:g}); the "
                  f"explicit integration will be unstable",
                  file=sys.stderr)
        t0 = time.perf_counter()
        tables = assemble(mesh, params)
        t_asm = time.perf_counter() - t0
        shift = buildings.surface_shift if buildings is not None else 0.0
        source = SourceModel.parse(params, surface_shift=shift)
        src_ids, src_forces = source.compute_forces(mesh, params)
        stations = setup_stations(mesh, params)
        sim = cls(params=params, cvm=cvm, mesh=mesh, tables=tables,
                  source=source, src_ids=src_ids, src_forces=src_forces,
                  stations=stations,
                  timings={"mesh": t_mesh, "assemble": t_asm})
        if params.include_nonlinear:
            from .config import ConfigFile
            from .nonlinear import NonlinearConfig, build_nonlinear_tables
            cfg = NonlinearConfig.parse(ConfigFile(params.numerical_path))
            sim.nl_tables = build_nonlinear_tables(mesh, params, cfg)
        if params.implement_drm:
            from .config import ConfigFile
            from .drm import DRMConfig, classify, write_coords, write_info
            dcfg = DRMConfig.parse(ConfigFile(params.numerical_path))
            shift = (buildings.surface_shift if buildings is not None
                     else 0.0)
            sim.drm_plan = classify(mesh, dcfg, surface_shift=shift)
            ddir = dcfg.directory
            if not os.path.isabs(ddir):
                ddir = os.path.join(rundir, ddir)
            sim.drm_dir = ddir
            if dcfg.part == "part0":
                write_coords(ddir, sim.drm_plan)
                write_info(ddir, sim.drm_plan)
                if verbose:
                    print(f"DRM part0: {len(sim.drm_plan.node_ids)} "
                          f"interface nodes written to {ddir}")
        return sim

    def run(self, dtype=None, chunk=None, total_steps=None, on_chunk=None,
            solver="auto", outputs=None, rundir=".", ndev=None,
            mc_path=None):
        """solver: 'bricks' (block-structured path; on the GPU its
        elastic operator is the fused element kernel), 'unstructured'
        (reference-layout oracle), or 'auto' (bricks when the mesh
        decomposes cleanly and no nonlinear/DRM/fixed-base physics
        needs the unstructured solver, else unstructured).

        outputs: optional SimOutputs handling 4-D volume / plane /
        checkpoint taps (solver_output_wavefield / solver_output_planes /
        solver_write_checkpoint, psolve.c:4275-4284).

        ndev: device count for the multi-chip production pipeline
        (parallel/driver.py).  None = auto: use every visible device
        (the reference uses every MPI rank); 1 = force single-device.
        mc_path: force a parallel path ('slab' or 'sharded')."""
        import jax
        import jax.numpy as jnp
        if solver not in ("auto", "bricks", "unstructured"):
            raise ValueError(
                f"unknown solver {solver!r} (choose 'auto', 'bricks' or "
                f"'unstructured')")
        if dtype is None:
            dtype = (jnp.float64 if jax.config.jax_enable_x64
                     else jnp.float32)
        p = self.params
        steps = total_steps if total_steps is not None else p.total_steps
        st = self.stations
        st_nodes = None if st is None else st.nodes
        st_phi = None if st is None else st.phi

        if outputs is not None and outputs.active:
            chunk = outputs.chunk_for(chunk or 1000)

        nl = None
        if self.nl_tables is not None:
            from .solver.step import attach_nonlinear
            nl = attach_nonlinear(self.mesh, p, self.tables,
                                  self.nl_tables, dtype=dtype)

        # stations inside nonlinear elements get extra one-hot corner
        # sampling rows so the plastic state can be replayed on the
        # host after the run (nonlinear_stations_init,
        # nonlinear.c:1947-2045)
        n_st = 0 if st is None else len(st.ids)
        nl_st_rows = []
        if nl is not None and st is not None:
            nlset = set(self.nl_tables.eidx.tolist())
            nl_st_rows = [j for j in range(n_st)
                          if int(st.eidx[j]) in nlset]
            if nl_st_rows:
                extra_nodes = np.repeat(st.nodes[nl_st_rows], 8, axis=0)
                extra_phi = np.tile(np.eye(8), (len(nl_st_rows), 1))
                st_nodes = np.concatenate([st.nodes, extra_nodes])
                st_phi = np.concatenate([st.phi, extra_phi])

        drm = None
        drm_rec = None
        on_samples = None
        if self.drm_plan is not None:
            dcfg = self.drm_plan.cfg
            if dcfg.part == "part2":
                from .drm import attach_drm
                drm = attach_drm(self.drm_plan, self.tables, p,
                                 self.drm_dir)
            elif dcfg.part == "part1":
                from .drm import DRMRecorder
                drm_rec = DRMRecorder(self.drm_dir, self.drm_plan)
                # step-0 record of the zero initial field (the
                # reference records at loop top, steps 0..T-1)
                drm_rec.record(0, np.zeros((self.mesh.nnum, 3)))
                # in-scan one-hot sampling of the DRM interface
                # nodes: part1 recording rides ANY solver path at
                # full chunk size, streaming each chunk's rows to the
                # part1 files via on_samples (the previous
                # chunk-boundary recorder forced chunk == print_rate
                # and a full-field device->host copy per record)
                drm_ids = np.asarray(self.drm_plan.node_ids)
                # all 8 slots carry the SAME node so the row is local
                # to whichever device owns it (the multi-chip station
                # plan requires one owner for a whole row)
                dn_ = np.repeat(drm_ids[:, None], 8,
                                axis=1).astype(np.int32)
                dphi_ = np.zeros((len(drm_ids), 8))
                dphi_[:, 0] = 1.0
                drm_row0 = 0 if st_nodes is None else len(st_nodes)
                st_nodes = (dn_ if st_nodes is None
                            else np.concatenate([st_nodes, dn_]))
                st_phi = (dphi_ if st_phi is None
                          else np.concatenate([st_phi, dphi_]))
                _pr = max(int(dcfg.print_rate), 1)

                def on_samples(s0, ys, _r0=drm_row0):
                    for i in range(ys.shape[0]):
                        ab = s0 + i
                        if ab and ab % _pr == 0:
                            drm_rec.record_rows(ab, ys[i, _r0:])
                    return ys[:, :_r0]

        # fixed-base buildings: load the prescribed base displacement
        # series (bldgs_load_fixedbase_disps, buildings.c:975-1146) and
        # route through the unstructured solver, which applies them
        fb_ids = fb_series = None
        bld = getattr(self.mesh, "buildings", None)
        if bld is not None and getattr(bld, "fixed_base", False):
            ids, which = bld.base_nodes(self.mesh)
            series = bld.base_disp_series(
                p.end_time - p.start_time, p.delta_t, steps,
                rundir=rundir)
            fb_ids = ids
            fb_series = series[:, which, :]

        # ---- multi-chip dispatch (the production pipeline) ----------
        # Library default stays single-device; the CLI auto-detects
        # the device count and passes ndev (psolve runs on every MPI
        # rank it is given; hpsolve runs on every chip it is given).
        if ndev is None:
            env = os.environ.get("HT_NDEV")
            ndev = int(env) if env else 0
        if ndev and ndev > 1:
            state, samples = self._run_multichip(
                ndev, dtype=dtype, chunk=chunk, steps=steps,
                on_chunk=on_chunk, outputs=outputs, rundir=rundir,
                st_nodes=st_nodes, st_phi=st_phi, prefer=mc_path,
                drm=drm, on_samples=on_samples,
                fb_ids=fb_ids, fb_series=fb_series)
            samples = self._replay_nl_stations(samples, nl_st_rows,
                                               n_st, st)
            if drm_rec is not None:
                drm_rec.close()
            return state, samples

        # the brick path runs elastic and BKT meshes that decompose
        # into bricks; nonlinear soil, DRM part 2 and fixed-base
        # buildings need the unstructured solver, which applies them
        plan = None
        if (solver in ("auto", "bricks") and fb_ids is None
                and nl is None and drm is None):
            try:
                from .solver.bricks import build_plan
                plan = build_plan(self.mesh)
            except RuntimeError:
                if solver == "bricks":
                    raise

        # ---- checkpoint restart (use_checkpoint = 1, psolve.c:4248) --
        start_step = 0
        init_state = None
        ck_conv = None
        if p.use_checkpoint == 1:
            ckdir = p.checkpoint_path or "checkpoints"
            if not os.path.isabs(ckdir):
                ckdir = os.path.join(rundir, ckdir)
            ckin = os.path.join(ckdir, "checkpoint.in")
            if os.path.exists(ckin):
                from .io.checkpoint import checkpoint_read
                start_step, u_now, u_prev, ck_conv, ck_extras = \
                    checkpoint_read(ckin)
                # validate the recorded physics against this run's
                # before slicing ck_conv by position (a non-BKT
                # nonlinear checkpoint restarted with damping=bkt
                # would otherwise silently misassign plastic state as
                # convolution state)
                if "damping" in ck_extras:
                    ck_damp = str(ck_extras["damping"])
                    if ck_damp != p.type_of_damping:
                        raise RuntimeError(
                            f"checkpoint was written with damping="
                            f"{ck_damp}; this run uses "
                            f"{p.type_of_damping}")
                if "has_nl" in ck_extras:
                    ck_nl = bool(ck_extras["has_nl"])
                    if ck_nl != bool(p.include_nonlinear):
                        raise RuntimeError(
                            f"checkpoint nonlinear presence "
                            f"({ck_nl}) does not match this run "
                            f"({bool(p.include_nonlinear)})")
                init_state = (u_now, u_prev)
        self.start_step = start_step

        hook = None
        snap_hook = None
        snap_every = None
        if outputs is not None and outputs.active:
            hook, snap_hook = outputs.make_hook(self.mesh, plan,
                                                on_chunk,
                                                start_step=start_step)
            if snap_hook is not None:
                snap_every = outputs.snap_every
        else:
            hook = on_chunk

        def fit_cm(x, tot):
            """Fit a restored field to the brick concat layout [3, tot]:
            accepts component-major [3, X] or a canonical global
            [N, 3] checkpoint."""
            x = np.asarray(x)
            if (x.ndim == 2 and x.shape[1] == 3
                    and x.shape[0] == self.mesh.nnum):
                x = x[plan.gnid_cat].T
            assert x.ndim == 2 and x.shape[0] == 3, \
                "checkpoint layout does not match the brick solver"
            if x.shape[1] < tot:
                x = np.pad(x, ((0, 0), (0, tot - x.shape[1])))
            return jnp.asarray(x[:, :tot], dtype)

        if plan is not None:
            from .solver.brickstep import run_brick_solver
            state = None
            if init_state is not None:
                TOT = plan.total_nb
                conv = ()
                if self.tables.damping == "bkt":
                    conv = _rebuild_brick_conv(plan, ck_conv, dtype)
                state = (fit_cm(init_state[0], TOT),
                         fit_cm(init_state[1], TOT), conv)
            state, samples = run_brick_solver(
                plan, self.tables, self.src_ids, self.src_forces,
                steps, p.delta_t, st_nodes=st_nodes, st_phi=st_phi,
                dtype=dtype, chunk=chunk, on_chunk=hook,
                state=state, start_step=start_step,
                on_snap=snap_hook, snap_every=snap_every,
                on_samples=on_samples)
            self.solver_path_name = "bricks"
        if plan is None:
            state = None
            if init_state is not None:
                u_now = np.asarray(init_state[0])
                assert u_now.ndim == 2 and u_now.shape[1] == 3, \
                    "checkpoint layout does not match the unstructured " \
                    "solver"
                nconv = 4 if self.tables.damping == "bkt" else 0
                conv = tuple(jnp.asarray(c, dtype)
                             for c in ck_conv[:nconv]) or None
                state = (jnp.asarray(u_now, dtype),
                         jnp.asarray(np.asarray(init_state[1]), dtype),
                         conv)
                if nl is not None:
                    # re-nest the plastic state (strain, pstrain,
                    # lambda [, geostatic bottom reactions])
                    nlflat = ck_conv[nconv:]
                    want = 4 if nl["geostatic"] else 3
                    if len(nlflat) != want:
                        raise RuntimeError(
                            f"checkpoint has {len(nlflat)} nonlinear "
                            f"state arrays; this run needs {want}")
                    state = state + (tuple(jnp.asarray(a, dtype)
                                           for a in nlflat),)
            state, samples = run_solver(
                self.tables, self.src_ids, self.src_forces, steps,
                p.delta_t, st_nodes=st_nodes, st_phi=st_phi,
                dtype=dtype, chunk=chunk, on_chunk=hook, nl=nl,
                drm=drm, state=state, start_step=start_step,
                fb_ids=fb_ids, fb_series=fb_series,
                on_snap=snap_hook, snap_every=snap_every,
                on_samples=on_samples)
            self.solver_path_name = "unstructured"
        if drm_rec is not None:
            drm_rec.close()
        if outputs is not None:
            outputs.close()

        samples = self._replay_nl_stations(samples, nl_st_rows, n_st,
                                           st)
        return state, samples

    def _replay_nl_stations(self, samples, nl_st_rows, n_st, st):
        """Replay the per-station plastic recursion from the sampled
        one-hot corner displacements (print_nonlinear_stations,
        nonlinear.c:1947-2228) and strip the extra sampling rows."""
        p = self.params
        self.nl_station_extras = {}
        if nl_st_rows:
            from .nonlinear import (nonlinear_station_series,
                                    station_constants)
            for i, j in enumerate(nl_st_rows):
                u8 = np.asarray(
                    samples[:, n_st + 8 * i:n_st + 8 * (i + 1), :])
                con = station_constants(self.nl_tables,
                                        int(st.eidx[j]))
                self.nl_station_extras[int(st.ids[j])] = \
                    nonlinear_station_series(
                        u8, con["h"], con, p.delta_t,
                        self.nl_tables.cfg.material_model,
                        self.nl_tables.cfg.plasticity_type.startswith(
                            "rate_dep"))
            samples = samples[:, :n_st]
        return samples

    def _run_multichip(self, ndev, dtype, chunk, steps, on_chunk,
                       outputs, rundir, st_nodes, st_phi, prefer=None,
                       drm=None, on_samples=None, fb_ids=None,
                       fb_series=None):
        """The full production loop sharded over `ndev` devices:
        stations, 4-D/plane taps, checkpoint write AND restart, and
        chunked source streaming — the complete solver_run surface
        (psolve.c:4241-4324) on a jax.sharding.Mesh."""
        import jax
        import jax.numpy as jnp
        from jax.sharding import Mesh
        from .parallel.driver import choose_path, run_multichip

        p = self.params
        devs = np.array(jax.devices()[:ndev])
        if len(devs) < ndev:
            raise RuntimeError(
                f"requested ndev={ndev} but only {len(devs)} devices "
                f"are visible")
        if (self.nl_tables is not None or drm is not None
                or fb_ids is not None):
            # nonlinear state, DRM effective forces and fixed-base
            # prescribed displacements are per-element / per-node —
            # they shard with the unstructured partition
            # (nonlinear.c:1671, drm.c:2316 and buildings.c:975-1146
            # run on every MPI rank)
            from .parallel.driver import ShardedPath
            from .parallel.partition import (shard_drm,
                                             shard_fixedbase,
                                             shard_nonlinear,
                                             shard_tables)
            if prefer not in (None, "sharded"):
                raise RuntimeError(
                    f"nonlinear/DRM/fixed-base multi-chip runs use the "
                    f"sharded path; cannot force mc_path={prefer}")
            ust = shard_tables(self.tables, self.mesh, ndev,
                               src_ids=self.src_ids)
            nl_b = None
            if self.nl_tables is not None:
                nl_b = shard_nonlinear(ust, self.tables, self.mesh,
                                       p, self.nl_tables, ndev)
            drm_b = shard_drm(ust, drm, ndev) if drm is not None \
                else None
            fb_b = (shard_fixedbase(ust, fb_ids, ndev)
                    if fb_ids is not None else None)
            path = ShardedPath(ust, self.mesh, dtype=dtype, nl=nl_b,
                               drm=drm_b, fb=fb_b, fb_series=fb_series)
        else:
            path = choose_path(self.mesh, self.tables, ndev,
                               src_ids=self.src_ids, dtype=dtype,
                               prefer=prefer)
        if st_nodes is not None and len(st_nodes):
            path.attach_stations(np.asarray(st_nodes),
                                 np.asarray(st_phi), dtype)

        # ---- checkpoint restart (psolve.c:4248-4253) ----------------
        start_step = 0
        state = None
        if p.use_checkpoint == 1:
            ckdir = p.checkpoint_path or "checkpoints"
            if not os.path.isabs(ckdir):
                ckdir = os.path.join(rundir, ckdir)
            ckin = os.path.join(ckdir, "checkpoint.in")
            if os.path.exists(ckin):
                from .io.checkpoint import checkpoint_read
                start_step, u_now, u_prev, ck_conv, ck_extras = \
                    checkpoint_read(ckin)
                if "damping" in ck_extras:
                    ck_damp = str(ck_extras["damping"])
                    if ck_damp != p.type_of_damping:
                        raise RuntimeError(
                            f"checkpoint was written with damping="
                            f"{ck_damp}; this run uses "
                            f"{p.type_of_damping}")
                tail = list(ck_conv)
                if tail:
                    mcp = str(ck_extras.get("mc_path", ""))
                    mcn = int(ck_extras.get("mc_ndev", 0))
                    if mcp != path.name or mcn != ndev:
                        raise RuntimeError(
                            f"checkpoint carry tail is shaped for "
                            f"path={mcp or 'single-device'}/"
                            f"ndev={mcn or 1}; this run uses "
                            f"{path.name}/ndev={ndev} (only "
                            f"displacement-only checkpoints are "
                            f"layout-elastic)")
                state = path.state_from_global(np.asarray(u_now),
                                               np.asarray(u_prev),
                                               tail)
        self.start_step = start_step

        hook = snap_fn = None
        snap_every = None
        if outputs is not None and outputs.active:
            chunk = outputs.chunk_for(chunk or 1000)
            hook, snap_fn = outputs.make_mc_hook(
                path, inner=on_chunk, start_step=start_step)
            if snap_fn is not None:
                snap_every = outputs.snap_every
        else:
            hook = on_chunk

        mesh_dev = Mesh(devs, (path.axis,))
        state, samples = run_multichip(
            path, mesh_dev, self.src_forces, steps, p.delta_t,
            chunk=chunk, state=state, start_step=start_step,
            on_chunk=hook, on_snap=snap_fn, snap_every=snap_every,
            on_samples=on_samples)
        if outputs is not None:
            outputs.close()
        self.nl_station_extras = {}
        self.mc_path_name = path.name
        self.mc_path = path
        self.solver_path_name = f"mc:{path.name}"
        return state, samples
