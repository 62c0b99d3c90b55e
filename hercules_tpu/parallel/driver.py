"""Production multi-chip simulation driver.

The reference runs its ENTIRE feature surface inside the MPI time loop
on every rank — station sampling, plane/4-D output, checkpointing,
source-force streaming (solver_run, psolve.c:4241-4324).  This module
gives the sharded paths the same surface: it wraps any parallel
path's raw per-step kernel (slab / unstructured sharded) in a
shard_map'ed lax.scan that

- samples stations in-loop every step (interpolate_station_
  displacements, psolve.c:6680-6795): each device computes a masked
  partial sample of the stations it owns; the host sums the disjoint
  per-device stacks after each chunk — no per-step collective;
- emits rate-strided (u, u_prev) snapshots from a nested scan for the
  4-D volume and plane output taps (solver_output_wavefield /
  solver_output_planes, psolve.c:4275-4284), converted to the global
  node layout on host;
- lands chunk boundaries on the checkpoint rate and writes the full
  carry (solver_write_checkpoint, psolve.c:3842) with enough metadata
  for bit-exact resume, including path-shaped BKT convolution state;
- streams source forces chunk-by-chunk from the (possibly memmapped)
  force table, the reference's read_myForces per-step seek/read
  (psolve.c:3652-3667) at chunk granularity.

Path selection (choose_path): uniform single-brick meshes get the slab
decomposition (the XLA stencil step); everything else, graded meshes
included, lands on the unstructured sharded path, which is always
available.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P


# ---------------------------------------------------------------------------
# station plans

def _localize(node_set: np.ndarray, st_nodes: np.ndarray):
    """(lidx [S,8], present [S]) of station nodes in one device's
    local node-id set (positions into node_set's own order)."""
    S = len(st_nodes)
    if S == 0:
        return np.zeros((0, 8), np.int32), np.zeros(0, bool)
    order = np.argsort(node_set, kind="stable")
    srt = node_set[order]
    pos = np.searchsorted(srt, st_nodes)
    pos = np.clip(pos, 0, len(srt) - 1)
    ok = srt[pos] == st_nodes
    lidx = np.where(ok, order[pos], 0).astype(np.int32)
    return lidx, ok.all(axis=1)


def _station_plan(node_sets, st_nodes):
    """Per-device station plan over a list of per-device global-node-id
    arrays.  Each station is assigned to the FIRST device holding all 8
    of its element's nodes (replicas of shared nodes are consistent, so
    the choice doesn't matter).  Returns (lidx [d,S,8], own [d,S])."""
    n_dev = len(node_sets)
    S = len(st_nodes)
    lidx = np.zeros((n_dev, S, 8), np.int32)
    own = np.zeros((n_dev, S), bool)
    assigned = np.zeros(S, bool)
    for d in range(n_dev):
        li, present = _localize(np.asarray(node_sets[d]), st_nodes)
        take = present & ~assigned
        lidx[d][take] = li[take]
        own[d] = take
        assigned |= take
    if S and not assigned.all():
        missing = np.flatnonzero(~assigned)
        raise RuntimeError(
            f"stations {missing.tolist()} not local to any device")
    return lidx, own


# ---------------------------------------------------------------------------
# path adapters

class _PathBase:
    """Common contract the driver runs against.

    Attributes set by subclasses:
      name, axis, n_dev, tdev (stacked pytree), state_spec, local_step
    """

    name = "?"

    def step_sample(self, t, carry, x):
        """local_step + pre-update masked station sample (row s of the
        output = displacement after s updates, matching run_solver)."""
        ys = self.sample(t, carry)
        carry, _ = self.local_step(t, carry, x)
        return carry, ys

    def sample(self, t, carry):
        raise NotImplementedError

    def attach_stations(self, st_nodes, st_phi, dtype):
        raise NotImplementedError

    def snap_pair(self, carry):
        return (carry[0], carry[1])

    def tail(self, state):
        """Carry tail (conv state etc.) as a flat tuple of stacked
        device arrays, for checkpointing."""
        return tuple(state[2:]) if len(state) > 2 else ()

    # -- layout conversions -------------------------------------------------
    def u_global(self, state):
        raise NotImplementedError

    def up_global(self, state):
        raise NotImplementedError

    def init_state(self):
        raise NotImplementedError

    def state_from_global(self, u, up, tail_flat):
        """Build the stacked carry from canonical global [N,3] fields.
        tail_flat: flat list of arrays from a checkpoint (must be
        empty unless the checkpoint was written by this same path and
        device count — validated by the caller)."""
        raise NotImplementedError


def _stack_pad(u, gnid_local, LEN, dtype):
    """[N,3] global -> [n_dev, 3, LEN] slab/brick fragments."""
    out = np.zeros((len(gnid_local), 3, LEN), dtype)
    for d, g in enumerate(gnid_local):
        out[d, :, : len(g)] = u[g].T
    return jnp.asarray(out)


class SlabXLAPath(_PathBase):
    """Uniform single-brick z-slab decomposition, XLA stencil step
    (parallel/slab.py: slab_step_builder)."""

    name = "slab"

    def __init__(self, st, mesh, axis="d", dtype=jnp.float32):
        from .slab import slab_step_builder
        self.st = st
        self.mesh = mesh
        self.axis = axis
        self.n_dev = st.n_dev
        self.dtype = dtype
        self.local_step, self.tdev, self.state_spec = \
            slab_step_builder(st, axis=axis, dtype=dtype)
        self._LEN = st.tot_local
        self._has_st = False

    def attach_stations(self, st_nodes, st_phi, dtype):
        lidx, own = _station_plan(self.st.gnid_local, st_nodes)
        self.tdev["st_lidx"] = jnp.asarray(lidx, jnp.int32)
        self.tdev["st_own"] = jnp.asarray(own[..., None], dtype)
        self.tdev["st_phi"] = jnp.asarray(
            np.broadcast_to(st_phi, (self.n_dev,) + st_phi.shape),
            dtype)
        self._has_st = True

    def sample(self, t, carry):
        if not self._has_st:
            return jnp.zeros((0, 3), self.dtype)
        u = carry[0]                         # [3, LEN]
        pts = u[:, t["st_lidx"]]             # [3, S, 8]
        s = jnp.einsum("sk,csk->sc", t["st_phi"], pts, precision="highest")
        return s * t["st_own"]

    def u_global(self, state):
        from .slab import slab_u_global
        return slab_u_global(self.st, np.asarray(state[0])
                             [:, :, : self.st.tot_local],
                             self.mesh.nnum)

    def up_global(self, state):
        from .slab import slab_u_global
        return slab_u_global(self.st, np.asarray(state[1])
                             [:, :, : self.st.tot_local],
                             self.mesh.nnum)

    def _u_stack(self, u):
        return _stack_pad(np.asarray(u), self.st.gnid_local, self._LEN,
                          np.dtype(jnp.zeros((), self.dtype).dtype))

    def _default_tail(self):
        st = self.st
        if st.damping == "bkt":
            return (tuple(jnp.zeros((st.n_dev, 24, st.meta.S),
                                    self.dtype) for _ in range(4)),)
        return ()

    def init_state(self):
        u = jnp.zeros((self.n_dev, 3, self._LEN), self.dtype)
        return (u, u) + self._default_tail()

    def state_from_global(self, u, up, tail_flat):
        base = (self._u_stack(u), self._u_stack(up))
        if not tail_flat:
            return base + self._default_tail()
        if self.st.damping == "bkt":
            assert len(tail_flat) == 4, "slab BKT tail must be 4 arrays"
            return base + (tuple(jnp.asarray(a, self.dtype)
                                 for a in tail_flat),)
        raise RuntimeError("unexpected checkpoint tail for slab path")


class ShardedPath(_PathBase):
    """Unstructured Z-order element-block decomposition
    (parallel/partition.py + parallel/sharded.py) — always available."""

    name = "sharded"

    def __init__(self, st, mesh, axis="d", dtype=jnp.float32,
                 nl=None, drm=None, fb=None, fb_series=None):
        from .sharded import sharded_step_builder
        self.st = st
        self.mesh = mesh
        self.axis = axis
        self.n_dev = st.n_dev
        self.dtype = dtype
        self.nl = nl
        self.local_step, self.tdev, self.state_spec = \
            sharded_step_builder(st, axis=axis, dtype=dtype, nl=nl,
                                 drm=drm, fb=fb)
        # fixed-base displacement series [T, B, 3] streamed as an
        # extra (replicated) xs component by run_multichip
        self.fb_series = fb_series if fb is not None else None
        self._has_st = False

    def attach_stations(self, st_nodes, st_phi, dtype):
        lidx, own = _station_plan(self.st.local_globals, st_nodes)
        self.tdev["st_lidx"] = jnp.asarray(lidx, jnp.int32)
        self.tdev["st_own"] = jnp.asarray(own[..., None], dtype)
        self.tdev["st_phi"] = jnp.asarray(
            np.broadcast_to(st_phi, (self.n_dev,) + st_phi.shape),
            dtype)
        self._has_st = True

    def sample(self, t, carry):
        if not self._has_st:
            return jnp.zeros((0, 3), self.dtype)
        u = carry[0]                          # [N_pad, 3]
        pts = u[t["st_lidx"]]                 # [S, 8, 3]
        s = jnp.einsum("sk,skc->sc", t["st_phi"], pts, precision="highest")
        return s * t["st_own"]

    def u_global(self, state):
        from .sharded import gather_global
        return gather_global(self.st, state[0], self.mesh.nnum)

    def up_global(self, state):
        from .sharded import gather_global
        return gather_global(self.st, state[1], self.mesh.nnum)

    def _u_stack(self, u):
        u = np.asarray(u)
        st = self.st
        npdt = np.dtype(jnp.zeros((), self.dtype).dtype)
        out = np.zeros((st.n_dev, st.N_pad, 3), npdt)
        for d, g in enumerate(st.local_globals):
            out[d, : len(g)] = u[g]
        return jnp.asarray(out)

    def _default_conv(self):
        st = self.st
        if st.damping == "bkt":
            z = jnp.zeros((st.n_dev, st.E_pad, 8, 3), self.dtype)
            return (z, z, z, z)
        return ()

    def init_state(self):
        from .sharded import init_sharded_state
        return init_sharded_state(self.st, self.dtype, nl=self.nl)

    def state_from_global(self, u, up, tail_flat):
        base = (self._u_stack(u), self._u_stack(up))
        nconv = 4 if self.st.damping == "bkt" else 0
        nnl = 0
        if self.nl is not None:
            nnl = 4 if self.nl["geostatic"] else 3
        if not tail_flat:
            init = self.init_state()
            return base + init[2:]
        if len(tail_flat) != nconv + nnl:
            raise RuntimeError(
                f"sharded checkpoint tail has {len(tail_flat)} "
                f"arrays; this run needs {nconv + nnl}")
        conv = tuple(jnp.asarray(a, self.dtype)
                     for a in tail_flat[:nconv])
        out = base + (conv,)
        if nnl:
            out = out + (tuple(jnp.asarray(a, self.dtype)
                               for a in tail_flat[nconv:]),)
        return out


# ---------------------------------------------------------------------------
# path selection

def choose_path(mesh, tables, n_dev, src_ids=None, dtype=jnp.float32,
                axis="d", prefer=None):
    """Build the parallel path for this mesh: the slab decomposition
    for a single uniform brick, the unstructured sharded path for
    everything else.  prefer: force 'slab' or 'sharded'."""
    if prefer not in (None, "slab", "sharded"):
        raise ValueError(
            f"unknown multi-chip path {prefer!r} (choose 'slab' or "
            f"'sharded')")
    if prefer in (None, "slab"):
        try:
            from .slab import build_slab_tables
            st = build_slab_tables(mesh, tables, n_dev, src_ids=src_ids)
            return SlabXLAPath(st, mesh, axis=axis, dtype=dtype)
        except RuntimeError:
            if prefer == "slab":
                raise
    from .partition import shard_tables
    ust = shard_tables(tables, mesh, n_dev, src_ids=src_ids)
    return ShardedPath(ust, mesh, axis=axis, dtype=dtype)


# ---------------------------------------------------------------------------
# the chunked multi-chip loop

def _build_scan(path: _PathBase, mesh_dev: Mesh, snap=False):
    axis = path.axis

    def scan_all(t, state, xs):
        t1 = jax.tree.map(lambda v: v[0], t)
        s1 = jax.tree.map(lambda v: v[0], state)
        if not snap:
            s1, ys = jax.lax.scan(partial(path.step_sample, t1), s1, xs)
            out = ys
        else:
            def superstep(carry, xsk):
                carry, ys = jax.lax.scan(partial(path.step_sample, t1),
                                         carry, xsk)
                return carry, (ys, path.snap_pair(carry))

            s1, out = jax.lax.scan(superstep, s1, xs)
        exp = lambda v: v[None]
        return (jax.tree.map(exp, s1), jax.tree.map(exp, out))

    tspec = jax.tree.map(lambda _: P(axis), path.tdev)
    sspec = path.state_spec
    ospec = P(axis) if not snap else (P(axis), (sspec[0], sspec[1]))
    smap = jax.shard_map(scan_all, mesh=mesh_dev,
                         in_specs=(tspec, sspec, P()),
                         out_specs=(sspec, ospec),
                         check_vma=False)
    return jax.jit(smap)


def run_multichip(path: _PathBase, mesh_dev: Mesh, src_forces,
                  total_steps, dt, chunk=None, state=None,
                  start_step=0, on_chunk=None, on_snap=None,
                  snap_every=None, on_samples=None):
    """Drive the full production loop over [start_step, total_steps).

    src_forces: [T, L, 3] host array/memmap (unscaled; dt^2 applied
    here, streamed chunk by chunk).
    on_chunk(done, state): chunk-boundary hook (checkpoints, monitor).
    on_samples(s0, ys): consumes each chunk's per-step sample rows
    (steps [s0, s0+len)) as they land on host and returns what to
    accumulate — streams large sample sets (DRM part-1 records).
    on_snap(done, uget, upget): rate-strided snapshot tap; uget()/
    upget() lazily assemble the global [N,3] fields.
    Returns (state, station_samples [T, S, 3])."""
    dtype = path.dtype
    scan_plain = _build_scan(path, mesh_dev, snap=False)
    scan_snap = (_build_scan(path, mesh_dev, snap=True)
                 if snap_every else None)
    if state is None:
        state = path.init_state()
    if chunk is None:
        chunk = min(total_steps, 1000)
    if snap_every:
        chunk = max(snap_every, chunk // snap_every * snap_every)
    dt2 = dt * dt
    L = src_forces.shape[1] if src_forces is not None else 0

    fb_series = getattr(path, "fb_series", None)

    def make_xs(s, k):
        if L:
            sf = jnp.asarray(src_forces[s : s + k] * dt2, dtype)
        else:
            sf = jnp.zeros((k, 0, 3), dtype)
        xs = (sf, jnp.arange(s, s + k, dtype=jnp.int32))
        if fb_series is not None:
            xs = xs + (jnp.asarray(fb_series[s : s + k], dtype),)
        return xs

    outs = []
    s = start_step
    while s < total_steps:
        k = min(chunk, total_steps - s)
        use_snap = (scan_snap is not None and k >= snap_every
                    and s % snap_every == 0)
        if use_snap:
            k = k // snap_every * snap_every
            K = k // snap_every
            xs = jax.tree.map(
                lambda a: a.reshape((K, snap_every) + a.shape[1:]),
                make_xs(s, k))
            state, (ys, snaps) = scan_snap(path.tdev, state, xs)
            ys = np.asarray(ys)          # [n_dev, K, snap, S, 3]
            ys = ys.sum(axis=0).reshape((k,) + ys.shape[3:])
            if on_samples is not None:
                ys = on_samples(s, ys)
            if on_snap is not None:
                for i in range(K):
                    pseudo = jax.tree.map(lambda a, _i=i: a[:, _i],
                                          (snaps[0], snaps[1]))
                    memo = {}

                    def uget(_p=pseudo, _m=memo):
                        if "u" not in _m:
                            _m["u"] = path.u_global((_p[0], _p[1]))
                        return _m["u"]

                    def upget(_p=pseudo, _m=memo):
                        if "up" not in _m:
                            _m["up"] = path.up_global((_p[0], _p[1]))
                        return _m["up"]

                    on_snap(s + (i + 1) * snap_every, uget, upget)
        else:
            xs = make_xs(s, k)
            state, ys = scan_plain(path.tdev, state, xs)
            ys = np.asarray(ys).sum(axis=0)           # [k, S, 3]
            if on_samples is not None:
                ys = on_samples(s, ys)
            if (on_snap is not None and snap_every
                    and (s + k) % snap_every == 0):
                memo = {}
                on_snap(s + k,
                        lambda _s=state, _m=memo: _m.setdefault(
                            "u", path.u_global(_s)),
                        lambda _s=state, _m=memo: _m.setdefault(
                            "up", path.up_global(_s)))
        outs.append(ys)
        if on_chunk is not None:
            on_chunk(s + k, state)
        s += k
    samples = np.concatenate(outs) if outs else np.zeros((0, 0, 3))
    return state, samples
