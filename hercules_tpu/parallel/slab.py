"""Multi-chip brick solver: slab domain decomposition.

For meshes whose brick decomposition is a single uniform brick (the
production large-mesh case), the device mesh splits the node grid into
contiguous z-slabs.  Each device runs the dense brick kernel on its
slab; the only communication is the element-force partial sums on the
two shared node *planes*, which are contiguous slices — so the halo
exchange is slice + ppermute + add, with zero gathers: the
equivalent of the reference's schedule_senddata halo
(psolve.c:4946-5079).

Displacements need no share-back: after the force exchange both
replicas of a shared plane hold identical totals and identical mass
tables, so their updates agree bitwise (same argument as
parallel/partition.py).

Graded meshes fall back to the unstructured sharded path.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..solver.bricks import build_plan
from ..solver.brickstep import HIGHEST, BrickMeta, assemble_brick_tables


@dataclass
class SlabTables:
    n_dev: int
    nzp: int            # global node planes
    nyp: int
    nxp: int
    ez_per: int         # max element layers per device (buffer size)
    tot_local: int      # local node count (incl. both shared planes)
    meta: BrickMeta
    dt: float
    damping: str
    m48: np.ndarray
    # uneven split: per-device owned layer counts (ez_lo or ez_lo+1,
    # extras on the first `nz % n_dev` devices); fragments are padded
    # to the static (ez_per+1)-plane buffer with zeroed coefficients,
    # and the bottom shared plane sits at the dynamic per-device
    # offset ez_of[idx]*plane
    ez_of: np.ndarray = None
    # multi-host: global device index of the first stacked table row
    # (build_slab_tables dev_slice); stacked arrays then hold only
    # this host's devices
    dev0: int = 0
    # stacked per-device arrays [n_dev, ...]
    c: dict = None
    inv_mass: np.ndarray = None
    mass_minusaM: np.ndarray = None
    src_lidx: np.ndarray = None     # [n_dev, L]
    src_mask: np.ndarray = None
    gnid_local: list = None         # per device: global node ids
    bkt: dict = None                # [n_dev, tot_local] BKT coefficients
    kmu: np.ndarray = None          # [24, 24] BKT operators
    kkappa: np.ndarray = None


def build_slab_tables(mesh, tables, n_dev, src_ids=None,
                      legacy_axes=True, dev_slice=None) -> SlabTables:
    """Split the single uniform brick into per-device fragments along
    the OUTER storage axis (z under the legacy layout; the largest xy
    extent when legacy_axes=False triggers build_plan's axis reorder
    for flat bricks).  Uneven splits are supported: devices own ez_lo or
    ez_lo+1 layers (extras to the first nz%n_dev devices), every
    fragment padded to the static (ez_hi+1)-plane buffer with zeroed
    element coefficients.

    dev_slice: optional (d0, d1) — build the stacked per-device
    coefficient/mass/source tables ONLY for devices [d0, d1) (a host's
    addressable devices in a multi-host pod), so no host materializes
    the whole pod's tables; gnid_local stays global (it is the gather
    map).  The returned SlabTables carries d0 in .dev0."""
    plan = build_plan(mesh, legacy_axes=legacy_axes)
    if len(plan.bricks) != 1 or len(plan.loose_eidx):
        raise RuntimeError("slab decomposition requires a single "
                           "uniform brick covering the whole mesh")
    b = plan.bricks[0]
    nzp, nyp, nxp = b.node_shape
    nz = nzp - 1
    if nz < n_dev:
        raise RuntimeError(f"{nz} element layers cannot feed "
                           f"{n_dev} devices (each needs >= 1)")
    ez_lo, r = divmod(nz, n_dev)
    ez_hi = ez_lo + (1 if r else 0)
    ez_of = np.array([ez_lo + (1 if d < r else 0)
                      for d in range(n_dev)], np.int32)
    plane = nyp * nxp
    tot_local = (ez_hi + 1) * plane

    # global brick tables (node-grid order)
    t_host, metas, TOT = assemble_brick_tables(plan, tables,
                                               src_ids=src_ids)
    gm = metas[0]
    local_meta = BrickMeta(off=0, nb=tot_local,
                           S=tot_local - gm.offs[7], offs=gm.offs)

    d0, d1 = dev_slice if dev_slice is not None else (0, n_dev)
    st = SlabTables(
        n_dev=n_dev, nzp=nzp, nyp=nyp, nxp=nxp, ez_per=ez_hi,
        tot_local=tot_local, meta=local_meta, dt=tables.dt,
        damping=tables.damping, m48=tables.m48, ez_of=ez_of)
    st.dev0 = d0

    cs = {k: [] for k in ("c1", "c2", "c3", "c4")}
    bks = ({k: [] for k in t_host["bkt"]}
           if tables.damping == "bkt" else None)
    invm, m1 = [], []
    srcl, srcm = [], []
    gnids = []
    L = len(src_ids) if src_ids is not None else 0

    def padded(v, real):
        """Zero-pad the last axis from `real` to tot_local."""
        if v.shape[-1] == tot_local:
            return v
        w = [(0, 0)] * (v.ndim - 1) + [(0, tot_local - v.shape[-1])]
        return np.pad(v, w)

    for d in range(d0, d1):
        ez_d = int(ez_of[d])
        n0 = (d * ez_lo + min(d, r)) * plane   # first local node
        real = (ez_d + 1) * plane
        n1 = n0 + real
        for k in cs:
            v = t_host[k][n0:n1].copy()
            # elements of the last local plane belong to the next slab
            v[ez_d * plane :] = 0.0
            cs[k].append(padded(v, real))
        if bks is not None:
            for k in bks:
                v = t_host["bkt"][k][n0:n1].copy()
                v[ez_d * plane :] = 0.0
                bks[k].append(padded(v, real))
        invm.append(padded(t_host["inv_mass"][n0:n1], real))
        m1.append(padded(t_host["mass_minusaM"][:, n0:n1], real))
        if L:
            pos = t_host["src_pos"].astype(np.int64)
            mine = (pos >= n0) & (pos < n1)
            # owner = lowest device: exclude the top shared plane for
            # devices > 0 (owned by the previous slab)
            if d > 0:
                mine &= pos >= n0 + plane
            sl = np.where(mine, pos - n0, tot_local - 1)
            srcl.append(sl.astype(np.int32))
            srcm.append(mine)

    st.c = {k: np.stack(v) for k, v in cs.items()}
    st.inv_mass = np.stack(invm)
    st.mass_minusaM = np.stack(m1)
    # gather maps for ALL devices (zero-copy views of gnid_cat)
    for d in range(n_dev):
        g0 = (d * ez_lo + min(d, r)) * plane
        gnids.append(
            plan.gnid_cat[g0 : g0 + (int(ez_of[d]) + 1) * plane])
    st.gnid_local = gnids
    if L:
        st.src_lidx = np.stack(srcl)
        st.src_mask = np.stack(srcm)
    if bks is not None:
        st.bkt = {k: np.stack(v) for k, v in bks.items()}
        st.kmu = t_host["kmu_cat"]
        st.kkappa = t_host["kkappa_cat"]
    return st


def slab_step_builder(st: SlabTables, axis="d", dtype=jnp.float32):
    """Raw per-step kernel for the XLA slab path: returns
    (local_step, tdev, state_spec) so callers (make_slab_step, the
    multi-chip driver) can wrap it in their own scan/shard_map."""
    m = st.meta
    plane = st.nyp * st.nxp
    mcat = jnp.asarray(st.m48.T, dtype)
    f = lambda x: jnp.asarray(x, dtype)
    tdev = {
        "c1": f(st.c["c1"]), "c2": f(st.c["c2"]),
        "c3": f(st.c["c3"]), "c4": f(st.c["c4"]),
        "inv_mass": f(st.inv_mass),
        "mass_minusaM": f(st.mass_minusaM),
    }
    has_src = st.src_lidx is not None
    if has_src:
        tdev["src_lidx"] = jnp.asarray(st.src_lidx, jnp.int32)
        tdev["src_mask"] = jnp.asarray(st.src_mask)
    bkt = st.damping == "bkt"
    if bkt:
        tdev["bkt"] = {k: f(v) for k, v in st.bkt.items()}
        kmu = jnp.asarray(st.kmu, dtype)
        kkappa = jnp.asarray(st.kkappa, dtype)
    n_dev = st.n_dev
    ez_of = jnp.asarray(st.ez_of, jnp.int32)

    def local_step(t, carry, x):
        srcf, _step = x
        if bkt:
            u, up, conv = carry
        else:
            u, up = carry
            conv = None

        ue = _field(u, m)
        upe = _field(up, m)
        du = ue - upe
        if not bkt:
            a = t["c1"][None, : m.S] * ue + t["c3"][None, : m.S] * du
            b = t["c2"][None, : m.S] * ue + t["c4"][None, : m.S] * du
            fe = -jnp.matmul(mcat, jnp.concatenate([a, b], axis=0),
                             precision=HIGHEST)
        else:
            # BKT convolutional viscoelasticity (damping.c:110-416):
            # local memory-variable recursion + matrix-free operators;
            # ghost-plane elements have zeroed coefficients so only
            # the owning slab contributes their force
            bk = t["bkt"]

            def bsl(name):
                return bk[name][None, : m.S]

            s0, s1, k0, k1 = conv

            def upd(f0, f1, p):
                f0n = (bsl(f"{p}_c2") * ue + bsl(f"{p}_c1") * upe
                       + bsl(f"{p}_e0") * f0)
                f1n = (bsl(f"{p}_c4") * ue + bsl(f"{p}_c3") * upe
                       + bsl(f"{p}_e1") * f1)
                return f0n, f1n

            s0, s1 = upd(s0, s1, "shear")
            k0, k1 = upd(k0, k1, "kappa")
            conv = (s0, s1, k0, k1)
            dvs = (bsl("shear_coef") * du
                   - (bsl("a0_shear") * s0 + bsl("a1_shear") * s1) + ue)
            dvk = (bsl("kappa_coef") * du
                   - (bsl("a0_kappa") * k0 + bsl("a1_kappa") * k1) + ue)
            fe = (bsl("mu_f") * jnp.matmul(kmu, dvs, precision=HIGHEST)
                  + bsl("kappa_f") * jnp.matmul(kkappa, dvk,
                                                precision=HIGHEST))

        force = jnp.zeros((3, st.tot_local), dtype)
        force = _scatter(force, fe, m)
        if has_src:
            sf = jnp.where(t["src_mask"][:, None], srcf, 0)
            force = force.at[:, t["src_lidx"]].add(sf.T)

        # halo exchange on the two shared node planes; the bottom
        # shared plane sits at the per-device dynamic offset
        # ez_of[idx]*plane (uneven splits pad the fragment tail)
        idx = jax.lax.axis_index(axis)
        zb = ez_of[idx] * plane
        z0 = jnp.zeros((), zb.dtype)
        f_bot = jax.lax.dynamic_slice(force, (z0, zb), (3, plane))
        down = jax.lax.ppermute(f_bot, axis,
                                [(i, (i + 1) % n_dev)
                                 for i in range(n_dev)])
        up_ = jax.lax.ppermute(force[:, :plane], axis,
                               [(i, (i - 1) % n_dev)
                                for i in range(n_dev)])
        bot = f_bot + jnp.where(idx < n_dev - 1, 1.0, 0.0) * up_
        force = jax.lax.dynamic_update_slice(force, bot, (z0, zb))
        top = force[:, :plane] + jnp.where(idx > 0, 1.0, 0.0) * down
        force = jnp.concatenate([top, force[:, plane:]], axis=1)

        # increment form (see solver/step.py): better f32 conditioning
        u_next = u + (force + t["mass_minusaM"] * (u - up)) \
            * t["inv_mass"][None]
        if bkt:
            return (u_next, u, conv), None
        return (u_next, u), None

    sspec = ((P(axis), P(axis), (P(axis),) * 4) if bkt
             else (P(axis), P(axis)))
    return local_step, tdev, sspec


def make_slab_step(st: SlabTables, mesh_dev: Mesh, axis="d",
                   dtype=jnp.float32):
    local_step, tdev, sspec = slab_step_builder(st, axis=axis,
                                                dtype=dtype)

    def scan_all(t, state, xs):
        t = jax.tree.map(lambda v: v[0], t)
        state = jax.tree.map(lambda v: v[0], state)
        state, _ = jax.lax.scan(partial(local_step, t), state, xs)
        return jax.tree.map(lambda v: v[None], state)

    tspec = jax.tree.map(lambda _: P(axis), tdev)
    smap = jax.shard_map(scan_all, mesh=mesh_dev,
                         in_specs=(tspec, sspec, P()), out_specs=sspec)
    return jax.jit(smap), tdev


def _field(u, m: BrickMeta):
    rows = []
    for j in range(8):
        rows.append(jax.lax.dynamic_slice_in_dim(u, m.offs[j], m.S,
                                                 axis=1))
    return jnp.concatenate(rows, axis=0)


def _scatter(force, fe, m: BrickMeta):
    for j in range(8):
        o = m.offs[j]
        seg = jax.lax.dynamic_slice_in_dim(force, o, m.S, axis=1)
        force = jax.lax.dynamic_update_slice_in_dim(
            force, seg + fe[3 * j : 3 * j + 3], o, axis=1)
    return force


def run_slab_solver(st: SlabTables, mesh_dev, src_forces, total_steps,
                    dt, dtype=jnp.float32, chunk=None):
    scan_fn, tdev = make_slab_step(st, mesh_dev, dtype=dtype)
    u = jnp.zeros((st.n_dev, 3, st.tot_local), dtype)
    if st.damping == "bkt":
        conv = tuple(jnp.zeros((st.n_dev, 24, st.meta.S), dtype)
                     for _ in range(4))
        state = (u, u, conv)
    else:
        state = (u, u)
    if chunk is None:
        chunk = min(total_steps, 1000)
    dt2 = dt * dt
    s = 0
    while s < total_steps:
        k = min(chunk, total_steps - s)
        xs = (jnp.asarray(src_forces[s : s + k] * dt2, dtype),
              jnp.arange(s, s + k, dtype=jnp.int32))
        state = scan_fn(tdev, state, xs)
        s += k
    return state


def slab_u_global(st: SlabTables, u_sharded, N):
    """Global [N, 3] field from the stacked slab states."""
    arr = np.asarray(u_sharded)          # [n_dev, 3, tot_local]
    u = np.zeros((N, 3), arr.dtype)
    for d in range(st.n_dev):
        g = st.gnid_local[d]
        u[g] = arr[d][:, : len(g)].T
    return u
