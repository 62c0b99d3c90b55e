"""Fused elastic brick element operator for Hopper (Pallas, Triton route).

The plain XLA version (brickstep.py) materialises the [24, S] corner
views of u and u_prev, the [48, S] coefficient combination, the [24, S]
element forces and eight read-modify-write passes of the node forces:
of order 1 KB of device-memory traffic per element.  This kernel reads
u, u_prev and the four element coefficients once and writes the node
force once.

Formulation (node-centric, no atomics, deterministic): program p owns a
contiguous node range of one brick.  The force on node n is the sum over
the 8 elements e_j = n - offs[j] that have n as corner j of row block j
of that element's force,

    f[n] = -sum_j  M[3j:3j+3, :] @ ab(e_j)
    ab(e) = [c1 ue + c3 (ue - upe) ; c2 ue + c4 (ue - upe)]   (48 values)
    ue(e) = u at the 8 corners e + offs[k]

so each program recomputes the 8 element windows around its nodes from
shifted contiguous loads (served from L1/L2), and writes only its own
nodes.  The constant [24, 48] operator is read as scalars from a small
table; every product is an f32 FMA, so no TF32 rounding enters.  The
loop over j stays rolled: fully unrolled, Triton took about three
minutes to compile the kernel on the H100.

The same kernel runs in Pallas' interpreter on the CPU for the tests.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

BLOCK = 256          # nodes per program (Triton block: a power of two)
NUM_WARPS = 4
_NCOL = 12           # program table: start, brick off, brick end, S, offs[8]
# Largest corner reach offs[7] the storage layout may give a brick
# (solver/bricks.py): a program's loads span its block plus 2*offs[7]
# nodes of u and u_prev, which must stay L2-resident (~1.5 MB here).
HALO_NODES = 1 << 15


def program_table(meta, TOT, block=BLOCK) -> np.ndarray:
    """[P, 12] int32 per-program table over the concatenated node buffer.

    One row per `block` nodes of each brick: (first node, brick offset,
    brick end, element count S, 8 corner offsets).  The loose-element
    nodes after the last brick get rows with S = 0, so the kernel writes
    zeros there and its output covers all TOT nodes."""
    rows = []
    for m in meta:
        for s in range(m.off, m.off + m.nb, block):
            rows.append([s, m.off, m.off + m.nb, m.S, *m.offs])
    end = max((m.off + m.nb for m in meta), default=0)
    for s in range(end, TOT, block):
        rows.append([s, end, TOT, 0] + [0] * 8)
    tab = np.asarray(rows, np.int64).reshape(-1, _NCOL)
    if tab.size and tab.max() >= 2 ** 31:
        raise ValueError("node buffer too large for int32 indexing")
    return tab.astype(np.int32)


def _kernel(tab_ref, m_ref, u_ref, up_ref, c1_ref, c2_ref, c3_ref,
            c4_ref, f_ref, *, TOT, block):
    p = pl.program_id(0)
    start = tab_ref[p, 0]
    boff = tab_ref[p, 1]
    bend = tab_ref[p, 2]
    S = tab_ref[p, 3]
    n = start + jnp.arange(block, dtype=jnp.int32)      # global nodes
    dt = f_ref.dtype

    def corner(j, k, eg, valid, cs, acc):
        c1, c2, c3, c4 = cs
        idx = eg + tab_ref[p, 4 + k]
        acc = list(acc)
        for c in range(3):
            uk = plgpu.load(u_ref.at[c * TOT + idx], mask=valid, other=0.0)
            upk = plgpu.load(up_ref.at[c * TOT + idx], mask=valid,
                             other=0.0)
            du = uk - upk
            a = c1 * uk + c3 * du
            b = c2 * uk + c4 * du
            for r in range(3):
                row = (3 * j + r) * 48
                acc[r] = (acc[r] - m_ref[row + 3 * k + c] * a
                          - m_ref[row + 24 + 3 * k + c] * b)
        return tuple(acc)

    def elem(j, acc):
        eg = n - tab_ref[p, 4 + j]                       # global element
        el = eg - boff
        valid = (el >= 0) & (el < S)
        cs = tuple(plgpu.load(r.at[eg], mask=valid, other=0.0)
                   for r in (c1_ref, c2_ref, c3_ref, c4_ref))
        for k in range(8):
            acc = corner(j, k, eg, valid, cs, acc)
        return acc

    acc = tuple(jnp.zeros((block,), dt) for _ in range(3))
    acc = jax.lax.fori_loop(0, 8, elem, acc)
    out = n < bend
    for r in range(3):
        plgpu.store(f_ref.at[r * TOT + n], acc[r], mask=out)


def make_elastic_force(meta, TOT, mcat, dtype=jnp.float32,
                       interpret=False, block=BLOCK):
    """Returns (force_fn, tab): force_fn(tab, u, up, c1, c2, c3, c4) gives
    the [3, TOT] elastic element force of every brick (zero on the loose
    nodes), the same as brickstep's plain segment loop."""
    tab = program_table(meta, TOT, block)
    mc = np.asarray(mcat, np.float64)
    assert mc.shape == (24, 48)
    kern = functools.partial(_kernel, TOT=TOT, block=block)
    call = pl.pallas_call(
        kern,
        out_shape=jax.ShapeDtypeStruct((3 * TOT,), dtype),
        grid=(len(tab),),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS),
        interpret=interpret,
        name="brick_elastic_force",
    )

    m = jnp.asarray(mc.reshape(-1), dtype)

    def force_fn(tab, u, up, c1, c2, c3, c4):
        f = call(tab, m, u.reshape(-1), up.reshape(-1), c1, c2, c3, c4)
        return f.reshape(3, TOT)

    return force_fn, tab
