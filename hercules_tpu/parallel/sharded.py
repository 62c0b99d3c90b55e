"""SPMD time stepping over a jax.sharding.Mesh.

One shard_map'ed lax.scan: per-device element kernels + segment sums,
dangling distribution applied to *partial* forces (linearity makes one
psum exact — see partition.py), a single [B,3] psum over the
shared-node boundary buffer per step, locally consistent updates.

This replaces the reference's schedule_senddata MPI halo machinery
(psolve.c:4946-5079) with one ICI collective per step instead of four.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P


def _dev_tables(st, dtype):
    f = lambda x: jnp.asarray(x, dtype)
    i = lambda x: jnp.asarray(x, jnp.int32)
    d = {
        "lnid": i(st.lnid),
        "c1": f(st.c["c1"]), "c2": f(st.c["c2"]),
        "c3": f(st.c["c3"]), "c4": f(st.c["c4"]),
        "inv_mass": f(st.inv_mass),
        "mass_minusaM": f(st.mass_minusaM),
        "scat_perm": i(st.scat_perm), "scat_seg": i(st.scat_seg),
        "dn_ids": i(st.dn_ids), "dn_anchors": i(st.dn_anchors),
        "dn_weights": f(st.dn_weights),
        "dn_scat_perm": i(st.dn_scat_perm),
        "dn_scat_seg": i(st.dn_scat_seg),
        "b_lidx": i(st.b_lidx), "b_mask": jnp.asarray(st.b_mask),
    }
    if st.src_lidx is not None:
        d["src_lidx"] = i(st.src_lidx)
        d["src_mask"] = jnp.asarray(st.src_mask)
    if st.damping == "bkt":
        d["bkt"] = {k: f(v) for k, v in st.bkt.items()}
    return d


def sharded_step_builder(st, axis="d", dtype=jnp.float32, nl=None,
                         drm=None, fb=None):
    """Raw per-step kernel for the unstructured sharded path: returns
    (local_step, tdev, state_spec).

    nl: stacked nonlinear bundle from partition.shard_nonlinear —
    the per-element plastic state rides the carry, sharded with the
    element partition exactly as nonlinear.c:1671-1823 runs on every
    MPI rank.  drm: stacked PART2 bundle from partition.shard_drm
    (effective forces lerped in-step, drm.c:2316-2437).  fb: stacked
    fixed-base plan from partition.shard_fixedbase; the prescribed
    displacements arrive as a third xs component [K, B, 3] and every
    device SETS its local copies post-update (buildings.c:975-1146)."""
    m48 = jnp.asarray(st.m48, dtype)
    kmu = jnp.asarray(st.kmu, dtype) if st.kmu is not None else None
    kkappa = (jnp.asarray(st.kkappa, dtype)
              if st.kkappa is not None else None)
    N_pad = st.N_pad
    damping = st.damping
    geostatic = bool(nl and nl["geostatic"])
    if nl is not None:
        from ..nonlinear import force_operator, strain_operator
        nl_S = jnp.asarray(strain_operator().reshape(48, 24), dtype)
        nl_F = jnp.asarray(
            force_operator().transpose(1, 0, 2).reshape(24, 48), dtype)
        if geostatic:
            nl_rise = jnp.asarray(nl["rise"], dtype)
    if drm is not None:
        drm_F = jnp.asarray(drm["F"], dtype)

    def local_step(t, carry, x):
        srcf, step_idx = x[0], x[1]
        fb_disp = x[2] if fb is not None else None
        if nl is not None:
            u_now, u_prev, conv, nlstate = carry
        else:
            u_now, u_prev, conv = carry
        E = t["lnid"].shape[0]
        ue = u_now[t["lnid"]].reshape(E, 24)
        upe = u_prev[t["lnid"]].reshape(E, 24)

        if damping != "bkt":
            du = ue - upe
            a = t["c1"][:, None] * ue + t["c3"][:, None] * du
            b = t["c2"][:, None] * ue + t["c4"][:, None] * du
            f_elem = -jnp.matmul(jnp.concatenate([a, b], 1), m48,
                                 precision="highest")
        else:
            bk = t["bkt"]
            ue3 = ue.reshape(E, 8, 3)
            upe3 = upe.reshape(E, 8, 3)
            s0, s1, k0, k1 = conv

            def upd(f0, f1, p):
                f0n = (bk[f"{p}_c2"][:, None, None] * ue3
                       + bk[f"{p}_c1"][:, None, None] * upe3
                       + bk[f"{p}_e0"][:, None, None] * f0)
                f1n = (bk[f"{p}_c4"][:, None, None] * ue3
                       + bk[f"{p}_c3"][:, None, None] * upe3
                       + bk[f"{p}_e1"][:, None, None] * f1)
                return f0n, f1n

            s0, s1 = upd(s0, s1, "shear")
            k0, k1 = upd(k0, k1, "kappa")
            du3 = ue3 - upe3
            dvs = (bk["shear_coef"][:, None, None] * du3
                   - (bk["a0_shear"][:, None, None] * s0
                      + bk["a1_shear"][:, None, None] * s1) + ue3)
            dvk = (bk["kappa_coef"][:, None, None] * du3
                   - (bk["a0_kappa"][:, None, None] * k0
                      + bk["a1_kappa"][:, None, None] * k1) + ue3)
            f_elem = (bk["mu_f"][:, None]
                      * jnp.matmul(dvs.reshape(E, 24), kmu, precision="highest")
                      + bk["kappa_f"][:, None]
                      * jnp.matmul(dvk.reshape(E, 24), kkappa, precision="highest"))
            conv = (s0, s1, k0, k1)

        # nonlinear state update first (solver_nonlinear_state,
        # psolve.c:4287); per-element, shard-local
        if nl is not None:
            from ..nonlinear import nl_state_update
            Enl = t["nl_lnid"].shape[0]
            ue_nl = u_now[t["nl_lnid"]].reshape(Enl, 24)
            d_nl = {"S": nl_S, "F": nl_F, "model": nl["model"],
                    "rate_dep": nl["rate_dep"]}
            for k in ("mu", "lam", "alpha", "k", "hard", "strainrate",
                      "sensitivity", "h"):
                d_nl[k] = t[f"nl_{k}"]
            nlstate = nl_state_update(d_nl, ue_nl, nlstate[:3],
                                      nl["dt"]) + nlstate[3:]

        # partial force: source (owner only) + element scatter
        force = jnp.zeros((N_pad, 3), dtype)
        if "src_lidx" in t:
            sf = jnp.where(t["src_mask"][:, None], srcf, 0)
            force = force.at[t["src_lidx"]].add(sf)
        if drm is not None:
            # DRM effective force lerp (drm.c:2316-2437); owner only
            k_ = jnp.minimum(step_idx // drm["aux"],
                             drm_F.shape[0] - 2)
            frac = ((step_idx % drm["aux"]).astype(dtype)
                    / drm["aux"])
            fd = (1.0 - frac) * drm_F[k_] + frac * drm_F[k_ + 1]
            fd = jnp.where(t["drm_mask"][:, None], fd, 0)
            force = force.at[t["drm_lidx"]].add(fd)
        flat = f_elem.reshape(-1, 3)[t["scat_perm"]]
        force = force + jax.ops.segment_sum(
            flat, t["scat_seg"], num_segments=N_pad,
            indices_are_sorted=True)

        if nl is not None:
            from ..nonlinear import nl_force
            fnl = nl_force(d_nl, nlstate[:3], nl["dt2"])   # [Enl, 24]
            flat_nl = fnl.reshape(-1, 3)[t["nl_scat_perm"]]
            force = force + jax.ops.segment_sum(
                flat_nl, t["nl_scat_seg"], num_segments=N_pad,
                indices_are_sorted=True)
            if geostatic:
                sig, pstr, ep, reactions = nlstate
                rise = nl_rise[jnp.minimum(step_idx,
                                           nl_rise.shape[0] - 1)]
                gw = t["nl_grav_W"] * rise
                force = force.at[:, 2].add(jax.ops.segment_sum(
                    gw[t["nl_gscat_perm"]], t["nl_gscat_seg"],
                    num_segments=N_pad, indices_are_sorted=True))
                # bottom reactions captured at the geostatic final
                # step (per-element => shard-local, psum-safe)
                Eb = t["nl_bot_lnid"].shape[0]
                ub = u_now[t["nl_bot_lnid"]].reshape(Eb, 24)
                a_ = t["nl_bc1"][:, None] * ub
                b_ = t["nl_bc2"][:, None] * ub
                kf = jnp.matmul(jnp.concatenate([a_, b_], 1), m48,
                                precision="highest").reshape(Eb, 8, 3)
                new_r = kf[:, 4:, 2] - t["nl_bot_W"][:, None]
                reactions = jnp.where(
                    step_idx == nl["final_step"], new_r, reactions)
                add = jnp.where(step_idx > nl["final_step"], 1.0, 0.0)
                force = force.at[:, 2].add(add * jax.ops.segment_sum(
                    reactions.reshape(-1)[t["nl_bscat_perm"]],
                    t["nl_bscat_seg"], num_segments=N_pad,
                    indices_are_sorted=True))
                nlstate = (sig, pstr, ep, reactions)

        # distribute dangling partials to anchors (linear => psum-safe)
        contrib = (force[t["dn_ids"]][:, None, :]
                   * t["dn_weights"][:, :, None]).reshape(-1, 3)
        force = force + jax.ops.segment_sum(
            contrib[t["dn_scat_perm"]], t["dn_scat_seg"],
            num_segments=N_pad, indices_are_sorted=True)

        # ONE boundary exchange: psum shared-node partials
        bbuf = jnp.where(t["b_mask"][:, None], force[t["b_lidx"]], 0)
        tot = jax.lax.psum(bbuf, axis)
        newv = jnp.where(t["b_mask"][:, None], tot, force[t["b_lidx"]])
        force = force.at[t["b_lidx"]].set(newv)

        # increment form (see solver/step.py): better f32 conditioning
        u_next = u_now + (force + t["mass_minusaM"]
                          * (u_now - u_prev)) * t["inv_mass"][:, None]
        if geostatic:
            # geostatic_displacements_fix: bottom z pinned during
            # loading; every device fixes its local replicas
            fix = (step_idx <= nl["final_step"])
            bz = u_next[t["nl_bot_nodes"], 2]
            u_next = u_next.at[t["nl_bot_nodes"], 2].set(
                jnp.where(fix & t["nl_bot_nodes_mask"], 0.0, bz))
        if fb_disp is not None:
            # fixed-base buildings: SET the prescribed base
            # displacements on every local copy (owned + replicas stay
            # consistent); same post-update, pre-dangling position as
            # the single-device solver (solver/step.py)
            cur = u_next[t["fb_lidx"]]
            vals = jnp.where(t["fb_mask"][:, None], fb_disp, cur)
            u_next = u_next.at[t["fb_lidx"]].set(vals)
        # dangling assignment (local anchors, consistent replicas)
        vals = (u_next[t["dn_anchors"]]
                * t["dn_weights"][:, :, None]).sum(1)
        live = t["dn_ids"] < N_pad - 1
        vals = jnp.where(live[:, None], vals, u_next[t["dn_ids"]])
        u_next = u_next.at[t["dn_ids"]].set(vals)
        # keep the trash slot zeroed
        u_next = u_next.at[N_pad - 1].set(0.0)

        if nl is not None:
            return (u_next, u_now, conv, nlstate), None
        return (u_next, u_now, conv), None

    tdev = _dev_tables(st, dtype)
    if nl is not None:
        f = lambda x: jnp.asarray(x, dtype)
        i = lambda x: jnp.asarray(x, jnp.int32)
        for k in ("mu", "lam", "alpha", "k", "hard", "strainrate",
                  "sensitivity", "h"):
            tdev[f"nl_{k}"] = f(nl["consts"][k])
        tdev["nl_lnid"] = i(nl["lnid"])
        tdev["nl_scat_perm"] = i(nl["scat_perm"])
        tdev["nl_scat_seg"] = i(nl["scat_seg"])
        if geostatic:
            for k in ("grav_W", "bc1", "bc2", "bot_W"):
                tdev[f"nl_{k}"] = f(nl[k])
            for k in ("gscat_perm", "gscat_seg", "bot_lnid",
                      "bscat_perm", "bscat_seg", "bot_nodes"):
                tdev[f"nl_{k}"] = i(nl[k])
            tdev["nl_bot_nodes_mask"] = jnp.asarray(
                nl["bot_nodes_mask"])
    if drm is not None:
        tdev["drm_lidx"] = jnp.asarray(drm["lidx"], jnp.int32)
        tdev["drm_mask"] = jnp.asarray(drm["mask"])
    if fb is not None:
        tdev["fb_lidx"] = jnp.asarray(fb["lidx"], jnp.int32)
        tdev["fb_mask"] = jnp.asarray(fb["mask"])
    conv_spec = ((P(axis), P(axis), P(axis), P(axis))
                 if damping == "bkt" else ())
    state_spec = (P(axis), P(axis), conv_spec)
    if nl is not None:
        nl_spec = (P(axis),) * (4 if geostatic else 3)
        state_spec = state_spec + (nl_spec,)
    return local_step, tdev, state_spec


def make_sharded_step(st, mesh: Mesh, axis="d", dtype=jnp.float32):
    """Returns (scan_fn, tables_device).

    scan_fn(tdev, state, xs) -> state; xs = per-step global source
    forces [K, L, 3] (replicated, dt^2-scaled)."""
    local_step, tdev, state_spec = sharded_step_builder(
        st, axis=axis, dtype=dtype)

    def scan_all(tables, state, xs):
        # inside shard_map the stacked per-device axis has local size 1
        tables = jax.tree.map(lambda x: x[0], tables)
        state = jax.tree.map(lambda x: x[0], state)
        step = partial(local_step, tables)
        state, _ = jax.lax.scan(step, state, xs)
        return jax.tree.map(lambda x: x[None], state)

    # shard_map specs: every per-device table has leading axis d
    tspec = jax.tree.map(lambda _: P(axis), tdev)
    smap = jax.shard_map(
        scan_all, mesh=mesh,
        in_specs=(tspec, state_spec, P()),
        out_specs=state_spec)
    return jax.jit(smap), tdev


def init_sharded_state(st, dtype=jnp.float32, nl=None):
    u = jnp.zeros((st.n_dev, st.N_pad, 3), dtype)
    conv = ()
    if st.damping == "bkt":
        z = jnp.zeros((st.n_dev, st.E_pad, 8, 3), dtype)
        conv = (z, z, z, z)
    if nl is None:
        return (u, u, conv)
    z6 = jnp.zeros((st.n_dev, nl["NLpad"], 8, 6), dtype)
    z8 = jnp.zeros((st.n_dev, nl["NLpad"], 8), dtype)
    nlstate = (z6, z6, z8)
    if nl["geostatic"]:
        nlstate = nlstate + (jnp.zeros((st.n_dev, nl["EBpad"], 4),
                                       dtype),)
    return (u, u, conv, nlstate)


def run_sharded(st, mesh, src_forces, total_steps, dt,
                dtype=jnp.float32, chunk=None, axis="d", state=None):
    """Chunked sharded time loop.  src_forces [T, L, 3] unscaled."""
    scan_fn, tdev = make_sharded_step(st, mesh, axis=axis, dtype=dtype)
    if state is None:
        state = init_sharded_state(st, dtype)
    if chunk is None:
        chunk = min(total_steps, 1000)
    dt2 = dt * dt
    s = 0
    while s < total_steps:
        k = min(chunk, total_steps - s)
        if src_forces is not None and src_forces.shape[1]:
            sf = jnp.asarray(src_forces[s : s + k] * dt2, dtype)
        else:
            sf = jnp.zeros((k, 0, 3), dtype)
        xs = (sf, jnp.arange(s, s + k, dtype=jnp.int32))
        state = scan_fn(tdev, state, xs)
        s += k
    return state


def gather_global(st, u_sharded, N):
    """Assemble the global displacement field from owned local slices."""
    u = np.zeros((N, 3), np.asarray(u_sharded).dtype)
    arr = np.asarray(u_sharded)
    for d in range(st.n_dev):
        u[st.owned_global[d]] = arr[d][st.owned_local[d]]
    return u
