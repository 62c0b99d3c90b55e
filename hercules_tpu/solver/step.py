"""The jitted explicit central-difference time step.

The reference's per-step pipeline (solver_run, psolve.c:4241-4324):
source scatter -> element stiffness+damping forces -> halo/dangling
force adjust -> node displacement update -> dangling displacement
assignment.  Here the element force is one batched [E,48] @ [48,24]
matmul against constant operators (see physics.kmats), the
element->node accumulation is a sorted segment-sum, and the dangling
adjusts are gather/scatter with precomputed index plans — all inside a
single lax.scan over time steps.

Station sampling happens in-loop: each step records the 8-node
trilinear interpolation (interpolate_station_displacements,
psolve.c:6680-6795) of the *current* displacement, so row s of the
output equals the reference's station line at step s.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def _dev(tables, dtype):
    """Cast solver tables to device arrays of the given dtype."""
    f = lambda x: jnp.asarray(x, dtype=dtype)
    i = lambda x: jnp.asarray(x, dtype=jnp.int32)
    d = {
        "lnid": i(tables.lnid),
        "m48": f(tables.m48),
        "c1": f(tables.c1), "c2": f(tables.c2),
        "c3": f(tables.c3), "c4": f(tables.c4),
        "inv_mass": f(tables.inv_mass),
        "mass_minusaM": f(tables.mass_minusaM),
        "scat_perm": i(tables.scat_perm), "scat_seg": i(tables.scat_seg),
        "dn_ids": i(tables.dn_ids),
        "dn_anchors": i(tables.dn_anchors),
        "dn_weights": f(tables.dn_weights),
        "dn_scat_perm": i(tables.dn_scat_perm),
        "dn_scat_seg": i(tables.dn_scat_seg),
    }
    if tables.damping == "bkt":
        d["kmu"] = f(tables.kmu)
        d["kkappa"] = f(tables.kkappa)
        d["bkt"] = {k: f(v) for k, v in tables.bkt.items()}
    return d


def element_forces(d, damping, u_now, u_prev, conv=None):
    """Element nodal forces [E, 8, 3] from current/previous displacement.

    rayleigh/mass/none: f = -(c1 M1 + c2 M2) u - (c3 M1 + c4 M2) du
    (compute_addforce_effective + damping_addforce).
    bkt: calc_conv + constant_Q_addforce; returns (f, new_conv)."""
    lnid = d["lnid"]
    E = lnid.shape[0]
    ue = u_now[lnid].reshape(E, 24)
    upe = u_prev[lnid].reshape(E, 24)

    if damping != "bkt":
        du = ue - upe
        a = d["c1"][:, None] * ue + d["c3"][:, None] * du
        b = d["c2"][:, None] * ue + d["c4"][:, None] * du
        ab = jnp.concatenate([a, b], axis=1)          # [E, 48]
        f = -jnp.matmul(ab, d["m48"], precision="highest")      # [E, 24]
        return f.reshape(E, 8, 3), None

    # ---- BKT ----
    bk = d["bkt"]
    ue3 = ue.reshape(E, 8, 3)
    upe3 = upe.reshape(E, 8, 3)
    s0, s1, k0, k1 = conv

    def upd(f0, f1, c1_, c2_, c3_, c4_, e0, e1):
        f0n = (c2_[:, None, None] * ue3 + c1_[:, None, None] * upe3
               + e0[:, None, None] * f0)
        f1n = (c4_[:, None, None] * ue3 + c3_[:, None, None] * upe3
               + e1[:, None, None] * f1)
        return f0n, f1n

    s0, s1 = upd(s0, s1, bk["shear_c1"], bk["shear_c2"], bk["shear_c3"],
                 bk["shear_c4"], bk["shear_e0"], bk["shear_e1"])
    k0, k1 = upd(k0, k1, bk["kappa_c1"], bk["kappa_c2"], bk["kappa_c3"],
                 bk["kappa_c4"], bk["kappa_e0"], bk["kappa_e1"])

    du3 = ue3 - upe3
    # damping vectors (constant_Q_addforce, damping.c:266-372)
    dvs = (bk["shear_coef"][:, None, None] * du3
           - (bk["a0_shear"][:, None, None] * s0
              + bk["a1_shear"][:, None, None] * s1) + ue3)
    dvk = (bk["kappa_coef"][:, None, None] * du3
           - (bk["a0_kappa"][:, None, None] * k0
              + bk["a1_kappa"][:, None, None] * k1) + ue3)
    f = (bk["mu_f"][:, None]
         * jnp.matmul(dvs.reshape(E, 24), d["kmu"], precision="highest")
         + bk["kappa_f"][:, None]
         * jnp.matmul(dvk.reshape(E, 24), d["kkappa"], precision="highest"))
    return f.reshape(E, 8, 3), (s0, s1, k0, k1)


def scatter_to_nodes(d, N, f_elem):
    """Element-corner forces -> node forces via sorted segment sum."""
    flat = f_elem.reshape(-1, 3)[d["scat_perm"]]
    return jax.ops.segment_sum(flat, d["scat_seg"], num_segments=N,
                               indices_are_sorted=True)


def dangling_distribute(d, N, v):
    """compute_adjust DISTRIBUTION: add each dangling value (prorated)
    to its anchors (psolve.c:5943-5988)."""
    if d["dn_ids"].shape[0] == 0:
        return v
    contrib = (v[d["dn_ids"]][:, None, :]
               * d["dn_weights"][:, :, None]).reshape(-1, 3)
    add = jax.ops.segment_sum(contrib[d["dn_scat_perm"]],
                              d["dn_scat_seg"], num_segments=N,
                              indices_are_sorted=True)
    return v + add


def dangling_assign(d, v):
    """compute_adjust ASSIGNMENT: dangling value = prorated sum of its
    anchors (psolve.c:5990-6036)."""
    if d["dn_ids"].shape[0] == 0:
        return v
    vals = (v[d["dn_anchors"]] * d["dn_weights"][:, :, None]).sum(axis=1)
    return v.at[d["dn_ids"]].set(vals)


def make_step(tables, src_ids, st_nodes=None, st_phi=None,
              dtype=jnp.float64, nl=None, drm=None):
    """Build the scan-able step function.

    carry = (u_now, u_prev, conv[, nl_state])   [conv () unless BKT]
    x     = (per-step source force [L, 3] (dt^2-scaled), step index)
    out   = per-step station displacements [S, 3] (empty if no stations)

    nl: optional nonlinear bundle from attach_nonlinear() — nonlinear
    elements' elastic force flows through the plastic stress integral
    instead of the linear stiffness operator (stiffness.c:46-105
    excludes them), with optional geostatic gravity loading.
    """
    d = _dev(tables, dtype)
    N = tables.N
    damping = tables.damping
    src_ids = jnp.asarray(src_ids, jnp.int32)
    if st_nodes is not None:
        st_nodes = jnp.asarray(st_nodes, jnp.int32)
        st_phi = jnp.asarray(st_phi, dtype)

    if nl is not None:
        # zero the linear stiffness coefficients of nonlinear elements
        # (linear_elements_mapping); damping c3/c4 stay active for all
        d["c1"] = d["c1"].at[nl["rows"]].set(0.0)
        d["c2"] = d["c2"].at[nl["rows"]].set(0.0)

    def step(carry, x):
        if len(x) == 3:
            srcf, step_idx, fb_disp = x
        else:
            srcf, step_idx = x
            fb_disp = None
        if nl is None:
            u_now, u_prev, conv = carry
        else:
            u_now, u_prev, conv, nlstate = carry

        # station sample of the current displacement (output row s)
        if st_nodes is not None:
            sample = jnp.einsum("sn,snc->sc", st_phi, u_now[st_nodes],
                                precision="highest")
        else:
            sample = jnp.zeros((0, 3), dtype)

        # nonlinear state update first (solver_nonlinear_state,
        # psolve.c:4287)
        if nl is not None:
            E_ = nl["lnid"].shape[0]
            ue = u_now[nl["lnid"]].reshape(E_, 24)
            from ..nonlinear import nl_state_update
            nlstate = nl_state_update(nl["d"], ue, nlstate[:3], nl["dt"]) \
                + nlstate[3:]

        # source force (compute_addforce_s, psolve.c:5912-5928)
        force = jnp.zeros((N, 3), dtype).at[src_ids].add(srcf)

        if drm is not None:
            # DRM effective force: lerp between force records
            # (solver_compute_effective_drm_force, drm.c:2316-2437)
            k = jnp.minimum(step_idx // drm["aux"],
                            drm["Fdev"].shape[0] - 2)
            frac = ((step_idx % drm["aux"]).astype(dtype)
                    / drm["aux"])
            fd = ((1.0 - frac) * drm["Fdev"][k]
                  + frac * drm["Fdev"][k + 1])
            force = force.at[drm["ids"]].add(fd)

        f_elem, conv = element_forces(d, damping, u_now, u_prev, conv)
        force = force + scatter_to_nodes(d, N, f_elem)

        if nl is not None:
            from ..nonlinear import nl_force
            fnl = nl_force(nl["d"], nlstate[:3], nl["dt2"])  # [Enl, 24]
            flat = fnl.reshape(-1, 3)[nl["scat_perm"]]
            force = force + jax.ops.segment_sum(
                flat, nl["scat_seg"], num_segments=N,
                indices_are_sorted=True)
            if nl["geostatic"]:
                force, nlstate = _geostatic_forces(
                    d, nl, force, u_now, step_idx, nlstate)

        force = dangling_distribute(d, N, force)

        # node update (solver_compute_displacement, psolve.c:4072-4114)
        # in increment form: mass2_minusaM - mass_minusaM == mass_simple
        # exactly (node_masses), so u+ = u + (F + m*(u - u-))/ms -- far
        # better f32 conditioning than the reference's m2*u - m*u- form
        # (the displacement increment is computed directly)
        u_next = u_now + (force + d["mass_minusaM"]
                          * (u_now - u_prev)) * d["inv_mass"][:, None]

        if nl is not None and nl["geostatic"]:
            # geostatic_displacements_fix: bottom z pinned during loading
            fix = (step_idx <= nl["final_step"])
            u_next = u_next.at[nl["bot_nodes"], 2].set(
                jnp.where(fix, 0.0, u_next[nl["bot_nodes"], 2]))

        if fb_disp is not None and "fb_ids" in d:
            # fixed-base buildings: prescribed base displacements
            # (bldgs_load_fixedbase_disps, buildings.c:1146)
            u_next = u_next.at[d["fb_ids"]].set(fb_disp)

        u_next = dangling_assign(d, u_next)

        if nl is None:
            return (u_next, u_now, conv), sample
        return (u_next, u_now, conv, nlstate), sample

    return step, d


def _geostatic_forces(d, nl, force, u_now, step_idx, nlstate):
    """compute_addforce_gravity + bottom reactions
    (nonlinear.c:1302-1504)."""
    sig, pstr, ep, reactions = nlstate
    rise = nl["rise"][jnp.minimum(step_idx, nl["rise"].shape[0] - 1)]
    gw = nl["grav_W"] * rise               # [E*8] per corner, dt^2 folded
    force = force.at[:, 2].add(jax.ops.segment_sum(
        gw[nl["gscat_perm"]], nl["gscat_seg"],
        num_segments=force.shape[0], indices_are_sorted=True))

    # bottom reactions captured exactly at the geostatic final step
    Eb = nl["bot_lnid"].shape[0]
    if Eb:
        ub = u_now[nl["bot_lnid"]].reshape(Eb, 24)
        a = nl["bc1"][:, None] * ub
        b = nl["bc2"][:, None] * ub
        kf = jnp.matmul(jnp.concatenate([a, b], 1), d["m48"],
                        precision="highest").reshape(Eb, 8, 3)
        new_r = kf[:, 4:, 2] - nl["bot_W"][:, None]   # [Eb, 4]
        reactions = jnp.where(step_idx == nl["final_step"], new_r,
                              reactions)
        add = jnp.where(step_idx > nl["final_step"], 1.0, 0.0)
        force = force.at[:, 2].add(add * jax.ops.segment_sum(
            reactions.reshape(-1)[nl["bscat_perm"]], nl["bscat_seg"],
            num_segments=force.shape[0], indices_are_sorted=True))
    return force, (sig, pstr, ep, reactions)


def attach_nonlinear(mesh, params, tables, nl_tables, dtype=jnp.float64):
    """Build the nonlinear bundle consumed by make_step."""
    from ..nonlinear import nl_device_tables, smooth_rise_factor

    t = nl_tables
    N = tables.N
    lnid = mesh.elem_lnid[t.eidx].astype(np.int32)
    seg = lnid.ravel()
    perm = np.argsort(seg, kind="stable").astype(np.int32)

    nl = {
        "d": nl_device_tables(t, dtype),
        "rows": jnp.asarray(t.eidx, jnp.int32),
        "lnid": jnp.asarray(lnid, jnp.int32),
        "scat_perm": jnp.asarray(perm, jnp.int32),
        "scat_seg": jnp.asarray(seg[perm], jnp.int32),
        "dt": params.delta_t,
        "dt2": params.delta_t ** 2,
        "geostatic": t.cfg.geostatic_loading_t > 0,
        "n": t.n,
    }
    if nl["geostatic"]:
        dt2 = params.delta_t ** 2
        final = t.cfg.geostatic_final_step(params.delta_t)
        nl["final_step"] = final
        # per-corner gravity weights (dt^2 folded), scattered to nodes
        gw = np.repeat(t.grav_W * dt2, 8)
        gseg = mesh.elem_lnid.ravel()
        gperm = np.argsort(gseg, kind="stable").astype(np.int32)
        nl["grav_W"] = jnp.asarray(gw, dtype)
        nl["gscat_perm"] = jnp.asarray(gperm, jnp.int32)
        nl["gscat_seg"] = jnp.asarray(gseg[gperm], jnp.int32)
        # smooth rise factor lookup for the geostatic window
        ngeo = int(t.cfg.geostatic_loading_t / params.delta_t)
        table = smooth_rise_factor(np.arange(final + 2), ngeo)
        nl["rise"] = jnp.asarray(table, dtype)
        # bottom elements: reaction capture + replay
        be = t.bot_eidx
        bl = mesh.elem_lnid[be].astype(np.int32)
        nl["bot_lnid"] = jnp.asarray(bl, jnp.int32)
        nl["bc1"] = jnp.asarray(tables.c1[be], dtype)
        nl["bc2"] = jnp.asarray(tables.c2[be], dtype)
        nl["bot_W"] = jnp.asarray(
            mesh.props["rho"][be] * mesh.edge_m[be] ** 3 * 9.8 * 0.125
            * dt2, dtype)
        bseg = bl[:, 4:].ravel()
        bperm = np.argsort(bseg, kind="stable").astype(np.int32)
        nl["bscat_perm"] = jnp.asarray(bperm, jnp.int32)
        nl["bscat_seg"] = jnp.asarray(bseg[bperm], jnp.int32)
        # bottom nodes for the displacement fix
        nl["bot_nodes"] = jnp.asarray(np.unique(bl[:, 4:]), jnp.int32)
    return nl


def init_state(tables, dtype=jnp.float64, nl=None):
    N, E = tables.N, tables.E
    u = jnp.zeros((N, 3), dtype)
    conv = None
    if tables.damping == "bkt":
        z = jnp.zeros((E, 8, 3), dtype)
        conv = (z, z, z, z)
    if nl is None:
        return (u, u, conv)
    Enl = nl["n"]
    z6 = jnp.zeros((Enl, 8, 6), dtype)
    z8 = jnp.zeros((Enl, 8), dtype)
    nlstate = (z6, z6, z8)
    if nl["geostatic"]:
        Eb = nl["bot_lnid"].shape[0]
        nlstate = nlstate + (jnp.zeros((Eb, 4), dtype),)
    return (u, u, conv, nlstate)


def run_solver(tables, src_ids, src_forces, total_steps, dt,
               st_nodes=None, st_phi=None, dtype=jnp.float64,
               chunk=None, state=None, start_step=0,
               on_chunk=None, nl=None, fb_ids=None, fb_series=None,
               drm=None, on_snap=None, snap_every=None,
               on_samples=None):
    """Run the time loop in jitted chunks.

    src_forces: [T, L, 3] host array (unscaled; dt^2 applied here).
    fb_ids/fb_series: optional fixed-base node ids [B] and prescribed
    displacements [T, B, 3].
    drm: optional PART2 bundle from hercules_tpu.drm.attach_drm.
    Returns (final_state, station_samples [T, S, 3])."""
    from .chunking import run_chunked

    if drm is not None:
        drm = dict(drm)
        drm["Fdev"] = jnp.asarray(drm.pop("F"), dtype)
    step, d = make_step(tables, src_ids, st_nodes, st_phi, dtype, nl=nl,
                        drm=drm)
    if fb_ids is not None:
        d["fb_ids"] = jnp.asarray(fb_ids, jnp.int32)

    if state is None:
        state = init_state(tables, dtype, nl=nl)
    if chunk is None:
        chunk = min(total_steps, 1000)
    dt2 = dt * dt

    def make_xs(s, k):
        xs = (jnp.asarray(src_forces[s : s + k] * dt2, dtype),
              jnp.arange(s, s + k, dtype=jnp.int32))
        if fb_series is not None:
            xs = xs + (jnp.asarray(fb_series[s : s + k], dtype),)
        return xs

    return run_chunked(step, state, make_xs, total_steps,
                       start_step=start_step, chunk=chunk,
                       on_chunk=on_chunk, on_snap=on_snap,
                       snap_every=snap_every, on_samples=on_samples)
