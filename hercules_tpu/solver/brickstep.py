"""Device-side brick solver: the structured fast path.

All state lives component-major ([3, total_nodes]) so each component is
one contiguous row.  Per brick, the plain element operator is:

  ue[24, S]   8 shifted slices of the brick's node field (3 comps each)
  ab[48, S]   per-element-coefficient combination (elementwise)
  f[24, S]    one [24,48] @ [48, S] contraction against the constant
              stiffness operators (physics/kmats.py)
  force      24 shifted slice-adds back onto the node grid

so the bulk of the step is dense slices + elementwise + matmul, with
zero gathers.  On the GPU the elastic operator of all bricks runs as one
fused kernel instead (brick_kernel.py).  The only irregular work is the
inter-brick reconciliation over shared/hanging nodes (plan built in
bricks.py), which touches O(interface) nodes.

Semantics match the unstructured solver step exactly (same operators,
same dangling distribute/assign algebra); tests/test_bricks.py checks
bitwise-level agreement in f64.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .bricks import BrickPlan

HIGHEST = jax.lax.Precision.HIGHEST
# element-sweep segment of the plain path: bounds the [24, S] dataflow
# on production-scale bricks (an unsegmented 7M-element brick peaks at
# several GB of live intermediates)
_SEG = 1 << 20


@dataclass
class BrickMeta:
    off: int
    nb: int
    S: int
    offs: tuple      # 8 corner flat offsets


def assemble_brick_tables(plan: BrickPlan, tables, src_ids=None,
                          st_nodes=None, st_phi=None):
    """Build host arrays for the brick step from global SolverTables."""
    TOT = plan.total_nb
    g = plan.gnid_cat
    ev = plan.evalid_cat
    ei = plan.eidx_cat

    t = {
        "mcat": tables.m48.T.copy(),               # [24, 48]
        "inv_mass": tables.inv_mass[g],            # [TOT]
        "mass_minusaM": tables.mass_minusaM[g].T.copy(),   # [3, TOT]
    }
    for k in ("c1", "c2", "c3", "c4"):
        t[k] = np.where(ev, getattr(tables, k)[ei], 0.0)

    if tables.damping == "bkt":
        t["kmu_cat"] = tables.kmu.T.copy()         # [24, 24]
        t["kkappa_cat"] = tables.kkappa.T.copy()
        t["bkt"] = {k: np.where(ev, v[ei], 0.0)
                    for k, v in tables.bkt.items()}

    # reconciliation plan
    t["ex_pos"] = plan.ex_pos
    t["ex_seg"] = plan.ex_seg
    t["grp_rep"] = plan.grp_rep
    t["n_groups"] = len(plan.grp_node)
    t["dn_grp"] = plan.dn_grp
    t["dn_anc_grp"] = plan.dn_anc_grp
    t["dn_wgt"] = plan.dn_wgt
    # positions of dangling copies for the assignment write-back
    if len(plan.dn_grp):
        isdn = np.zeros(t["n_groups"], bool)
        isdn[plan.dn_grp] = True
        grp2dn = np.zeros(t["n_groups"], np.int64)
        grp2dn[plan.dn_grp] = np.arange(len(plan.dn_grp))
        m = isdn[plan.ex_seg]
        t["dnc_pos"] = plan.ex_pos[m]
        t["dnc_src"] = grp2dn[plan.ex_seg[m]].astype(np.int32)
    else:
        t["dnc_pos"] = np.zeros(0, np.int32)
        t["dnc_src"] = np.zeros(0, np.int32)

    # source plan: first concat copy of each source node
    if src_ids is not None and len(src_ids):
        uniq, first = np.unique(plan.gnid_cat, return_index=True)
        pos = first[np.searchsorted(uniq, src_ids)]
        assert (plan.gnid_cat[pos] == src_ids).all()
        t["src_pos"] = pos.astype(np.int32)
    # stations: first copy of each interpolation node
    if st_nodes is not None:
        uniq, first = np.unique(plan.gnid_cat, return_index=True)
        pos = first[np.searchsorted(uniq, st_nodes.ravel())]
        t["st_pos"] = pos.reshape(st_nodes.shape).astype(np.int32)
        t["st_phi"] = st_phi

    # loose elements (graded-shell slivers): gather/scatter tables
    le = plan.loose_eidx
    t["l_rows"] = plan.loose_rows                    # [El, 8]
    for k in ("c1", "c2", "c3", "c4"):
        t[f"l_{k}"] = getattr(tables, k)[le]
    lseg = plan.loose_rows.ravel()
    lperm = np.argsort(lseg, kind="stable").astype(np.int32)
    t["l_perm"] = lperm
    t["l_seg"] = lseg[lperm].astype(np.int32)
    if tables.damping == "bkt":
        t["l_bkt"] = {k: v[le] for k, v in tables.bkt.items()}

    meta = []
    for b in plan.bricks:
        offs = tuple(b.corner_offsets())
        meta.append(BrickMeta(off=b.off, nb=b.nb, S=b.nb - offs[7],
                              offs=offs))
    return t, meta, TOT


def _to_device(t, dtype):
    f = lambda x: jnp.asarray(x, dtype)
    i = lambda x: jnp.asarray(x, jnp.int32)
    d = {}
    for k, v in t.items():
        if k in ("n_groups",):
            d[k] = v
        elif k in ("bkt", "l_bkt"):
            d[k] = {kk: f(vv) for kk, vv in v.items()}
        elif k in ("ex_pos", "ex_seg", "grp_rep", "dn_grp", "dn_anc_grp",
                   "dnc_pos", "dnc_src", "src_pos", "st_pos", "l_rows",
                   "l_perm", "l_seg"):
            d[k] = i(v)
        elif k == "dn_wgt" or not isinstance(v, np.ndarray):
            d[k] = f(v) if isinstance(v, np.ndarray) else v
        else:
            d[k] = f(v)
    return d


def _elem_field(u, meta: BrickMeta):
    """[24, S] element-corner view of the brick node field [3, nb]:
    row 3j+c = component c at corner j."""
    rows = []
    for j in range(8):
        o = meta.offs[j]
        rows.append(jax.lax.dynamic_slice_in_dim(u, o, meta.S, axis=1))
    return jnp.concatenate(rows, axis=0)  # [24, S] rows (j, c) grouped


def _scatter_back(force_b, f, meta: BrickMeta):
    """Add f [24, S] back onto the brick node field [3, nb]."""
    for j in range(8):
        o = meta.offs[j]
        seg = jax.lax.dynamic_slice_in_dim(force_b, o, meta.S, axis=1)
        seg = seg + f[3 * j : 3 * j + 3]
        force_b = jax.lax.dynamic_update_slice_in_dim(force_b, seg, o,
                                                      axis=1)
    return force_b


def plain_elastic_force(d, u, up, meta, TOT):
    """[3, TOT] elastic element force of every brick (zero on the loose
    nodes): the plain XLA operator, segmented along each brick's element
    sweep.  d holds mcat and c1..c4 on the concatenated node buffer."""
    force = jnp.zeros((3, TOT), u.dtype)
    for m in meta:
        sl_u = jax.lax.dynamic_slice_in_dim(u, m.off, m.nb, axis=1)
        sl_up = jax.lax.dynamic_slice_in_dim(up, m.off, m.nb, axis=1)
        fb = jnp.zeros((3, m.nb), u.dtype)
        for q0 in range(0, m.S, _SEG):
            qn = min(_SEG, m.S - q0)

            def cut(v):
                return jax.lax.dynamic_slice_in_dim(v, m.off + q0, qn)

            ue = jnp.concatenate(
                [jax.lax.dynamic_slice_in_dim(sl_u, o + q0, qn, axis=1)
                 for o in m.offs], axis=0)
            upe = jnp.concatenate(
                [jax.lax.dynamic_slice_in_dim(sl_up, o + q0, qn, axis=1)
                 for o in m.offs], axis=0)
            du = ue - upe
            a = cut(d["c1"])[None] * ue + cut(d["c3"])[None] * du
            b = cut(d["c2"])[None] * ue + cut(d["c4"])[None] * du
            f = -jnp.matmul(d["mcat"], jnp.concatenate([a, b], axis=0),
                            precision=HIGHEST)
            for j in range(8):
                o = m.offs[j] + q0
                seg = jax.lax.dynamic_slice_in_dim(fb, o, qn, axis=1)
                fb = jax.lax.dynamic_update_slice_in_dim(
                    fb, seg + f[3 * j:3 * j + 3], o, axis=1)
        segf = jax.lax.dynamic_slice_in_dim(force, m.off, m.nb, axis=1)
        force = jax.lax.dynamic_update_slice_in_dim(force, segf + fb,
                                                    m.off, axis=1)
    return force


def use_element_kernel(damping, platform=None):
    """The fused element kernel runs the elastic brick operator on the
    GPU; the CPU (and BKT attenuation) keep the plain XLA operator."""
    platform = platform or jax.default_backend()
    return platform == "gpu" and damping != "bkt"


def make_brick_step(t_host, meta, TOT, damping, dtype=jnp.float32,
                    kernel=None, interpret=False):
    """Returns (step, d): step(d, carry, x) takes the device tables as
    an explicit argument so node-scale arrays lower as program
    parameters, not HLO literals (see chunking.run_chunked).

    kernel: run the elastic operator as the fused Pallas kernel
    (default: use_element_kernel); interpret runs it in Pallas'
    interpreter (tests on the CPU)."""
    d = _to_device(t_host, dtype)
    G = t_host["n_groups"]
    has_src = "src_pos" in d
    has_st = "st_pos" in d
    has_dn = len(t_host["dn_grp"]) > 0
    if kernel is None:
        kernel = use_element_kernel(damping)
    if kernel:
        if damping == "bkt":
            raise ValueError("the fused element kernel is elastic-only")
        from .brick_kernel import make_elastic_force
        kforce, tab = make_elastic_force(meta, TOT, t_host["mcat"],
                                         dtype, interpret=interpret)
        d["ktab"] = jnp.asarray(tab)

    def step(d, carry, x):
        mcat = d["mcat"]
        srcf, step_idx = x
        u, up, conv = carry

        if has_st:
            sample = jnp.einsum("sn,csn->sc", d["st_phi"],
                                u[:, d["st_pos"]], precision=HIGHEST)
        else:
            sample = jnp.zeros((0, 3), dtype)

        if damping == "bkt":
            force = jnp.zeros((3, TOT), dtype)
        elif kernel:
            force = kforce(d["ktab"], u, up, d["c1"], d["c2"], d["c3"],
                           d["c4"])
        else:
            force = plain_elastic_force(d, u, up, meta, TOT)
        if has_src:
            force = force.at[:, d["src_pos"]].add(srcf.T)

        new_conv = []
        for bi, m in enumerate(meta if damping == "bkt" else ()):
            sl_u = jax.lax.dynamic_slice_in_dim(u, m.off, m.nb, axis=1)
            sl_up = jax.lax.dynamic_slice_in_dim(up, m.off, m.nb, axis=1)
            # BKT path (memory variables carried per element)
            ue = _elem_field(sl_u, m)       # [24, S]
            upe = _elem_field(sl_up, m)
            bk = d["bkt"]

            def bsl(name):
                return jax.lax.dynamic_slice_in_dim(
                    bk[name], m.off, m.S)

            s0, s1, k0, k1 = conv[bi]

            def upd(f0, f1, p):
                f0n = (bsl(f"{p}_c2")[None] * ue
                       + bsl(f"{p}_c1")[None] * upe
                       + bsl(f"{p}_e0")[None] * f0)
                f1n = (bsl(f"{p}_c4")[None] * ue
                       + bsl(f"{p}_c3")[None] * upe
                       + bsl(f"{p}_e1")[None] * f1)
                return f0n, f1n

            s0, s1 = upd(s0, s1, "shear")
            k0, k1 = upd(k0, k1, "kappa")
            new_conv.append((s0, s1, k0, k1))
            du = ue - upe
            dvs = (bsl("shear_coef")[None] * du
                   - (bsl("a0_shear")[None] * s0
                      + bsl("a1_shear")[None] * s1) + ue)
            dvk = (bsl("kappa_coef")[None] * du
                   - (bsl("a0_kappa")[None] * k0
                      + bsl("a1_kappa")[None] * k1) + ue)
            mu_f = jax.lax.dynamic_slice_in_dim(
                bk["mu_f"], m.off, m.S)
            kp_f = jax.lax.dynamic_slice_in_dim(
                bk["kappa_f"], m.off, m.S)
            f = (mu_f[None] * jnp.matmul(d["kmu_cat"], dvs,
                                         precision=HIGHEST)
                 + kp_f[None] * jnp.matmul(d["kkappa_cat"], dvk,
                                           precision=HIGHEST))

            fb = jnp.zeros((3, m.nb), dtype)
            fb = _scatter_back(fb, f, m)
            seg = jax.lax.dynamic_slice_in_dim(force, m.off, m.nb, axis=1)
            force = jax.lax.dynamic_update_slice_in_dim(
                force, seg + fb, m.off, axis=1)

        # ---- loose elements: gather/scatter path --------------------
        El = d["l_rows"].shape[0]
        if El:
            uT = u.T                                   # [TOT, 3]
            upT = up.T
            ue = uT[d["l_rows"]].reshape(El, 24)
            upe = upT[d["l_rows"]].reshape(El, 24)
            if damping != "bkt":
                du = ue - upe
                a = d["l_c1"][:, None] * ue + d["l_c3"][:, None] * du
                b = d["l_c2"][:, None] * ue + d["l_c4"][:, None] * du
                lf = -jnp.matmul(jnp.concatenate([a, b], 1), mcat.T,
                                 precision=HIGHEST)
            else:
                lbk = d["l_bkt"]
                ue3 = ue.reshape(El, 8, 3)
                upe3 = upe.reshape(El, 8, 3)
                ls0, ls1, lk0, lk1 = conv[-1]

                def lupd(f0, f1, p):
                    f0n = (lbk[f"{p}_c2"][:, None, None] * ue3
                           + lbk[f"{p}_c1"][:, None, None] * upe3
                           + lbk[f"{p}_e0"][:, None, None] * f0)
                    f1n = (lbk[f"{p}_c4"][:, None, None] * ue3
                           + lbk[f"{p}_c3"][:, None, None] * upe3
                           + lbk[f"{p}_e1"][:, None, None] * f1)
                    return f0n, f1n

                ls0, ls1 = lupd(ls0, ls1, "shear")
                lk0, lk1 = lupd(lk0, lk1, "kappa")
                new_conv.append((ls0, ls1, lk0, lk1))
                du3 = ue3 - upe3
                dvs = (lbk["shear_coef"][:, None, None] * du3
                       - (lbk["a0_shear"][:, None, None] * ls0
                          + lbk["a1_shear"][:, None, None] * ls1) + ue3)
                dvk = (lbk["kappa_coef"][:, None, None] * du3
                       - (lbk["a0_kappa"][:, None, None] * lk0
                          + lbk["a1_kappa"][:, None, None] * lk1) + ue3)
                lf = (lbk["mu_f"][:, None]
                      * jnp.matmul(dvs.reshape(El, 24), d["kmu_cat"].T,
                                   precision=HIGHEST)
                      + lbk["kappa_f"][:, None]
                      * jnp.matmul(dvk.reshape(El, 24), d["kkappa_cat"].T,
                                   precision=HIGHEST))
            flat = lf.reshape(-1, 3)[d["l_perm"]]
            add = jax.ops.segment_sum(flat, d["l_seg"], num_segments=TOT,
                                      indices_are_sorted=True)
            force = force + add.T

        # ---- irregular reconciliation over shared/hanging nodes ----
        if G:
            vals = force[:, d["ex_pos"]].T                 # [K, 3]
            tot = jax.ops.segment_sum(vals, d["ex_seg"], num_segments=G,
                                      indices_are_sorted=True)
            if has_dn:
                contrib = (tot[d["dn_grp"]][:, None, :]
                           * d["dn_wgt"][:, :, None])      # [D, 4, 3]
                tot = tot.at[d["dn_anc_grp"]].add(contrib)
            force = force.at[:, d["ex_pos"]].set(tot[d["ex_seg"]].T)

        # increment form (see solver/step.py): better f32 conditioning
        u_next = u + (force + d["mass_minusaM"] * (u - up)) \
            * d["inv_mass"][None, :]

        if has_dn:
            u_rep = u_next[:, d["grp_rep"]].T              # [G, 3]
            dnv = (u_rep[d["dn_anc_grp"]]
                   * d["dn_wgt"][:, :, None]).sum(axis=1)  # [D, 3]
            u_next = u_next.at[:, d["dnc_pos"]].set(
                dnv[d["dnc_src"]].T)

        return (u_next, u, tuple(new_conv) if damping == "bkt"
                else conv), sample

    return step, d


def init_brick_state(meta, TOT, damping, dtype=jnp.float32,
                     n_loose=0):
    u = jnp.zeros((3, TOT), dtype)
    conv = ()
    if damping == "bkt":
        conv = tuple(
            tuple(jnp.zeros((24, m.S), dtype) for _ in range(4))
            for m in meta)
        if n_loose:
            conv = conv + (
                tuple(jnp.zeros((n_loose, 8, 3), dtype)
                      for _ in range(4)),)
    return (u, u, conv)


def run_brick_solver(plan, tables, src_ids, src_forces, total_steps, dt,
                     st_nodes=None, st_phi=None, dtype=jnp.float32,
                     chunk=None, state=None, on_chunk=None,
                     start_step=0, on_snap=None, snap_every=None,
                     on_samples=None):
    """Chunked brick time loop; same contract as solver.step.run_solver."""
    from .chunking import run_chunked

    t_host, meta, TOT = assemble_brick_tables(
        plan, tables, src_ids=src_ids, st_nodes=st_nodes, st_phi=st_phi)
    step, d = make_brick_step(t_host, meta, TOT, tables.damping, dtype)
    if state is None:
        state = init_brick_state(meta, TOT, tables.damping, dtype,
                                 n_loose=len(plan.loose_eidx))
    if chunk is None:
        chunk = min(total_steps, 1000)
    dt2 = dt * dt

    def make_xs(s, k):
        return (jnp.asarray(src_forces[s : s + k] * dt2, dtype),
                jnp.arange(s, s + k, dtype=jnp.int32))

    return run_chunked(step, state, make_xs, total_steps,
                       start_step=start_step, chunk=chunk,
                       on_chunk=on_chunk, on_snap=on_snap,
                       snap_every=snap_every, consts=d,
                       on_samples=on_samples)


def brick_u_global(plan, u_cat, N):
    """Global [N, 3] displacement from the concatenated brick field."""
    u = np.zeros((N, 3), np.asarray(u_cat).dtype)
    arr = np.asarray(u_cat).T  # [TOT, 3]
    u[plan.gnid_cat] = arr
    return u
