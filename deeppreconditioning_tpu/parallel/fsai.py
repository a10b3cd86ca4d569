"""Distributed FSAI / NeuralFSAI apply for the sharded PCG solver.

Completes SURVEY §2.4 item 4 for the flagship technique: the
factor-form preconditioner apply z = C q(B) q(B)^T C^T r
(ops/factor_apply.make_fsai_poly_apply) over a 1-D row partition.

C is lower triangular on the FSAI pattern, whose row extent per column
is bandwidth-bounded for FVM/Poisson orderings — exactly like A itself
(parallel/partition.py).  So both triangular gathers distribute with a
*single-neighbor halo exchange* instead of an all-gather:

    t = C^T r : column j reads rows S_j ⊆ [j, j + band] — a RIGHT halo
                of r (first `halo` entries of the right neighbor);
    z = C  t  : row i reads columns j ∈ [i - band, i] — a LEFT halo of
                t (last `halo` entries of the left neighbor).

Index maps are precomputed host-side per shard (the partition is
contiguous and static), so the device apply is two ppermutes and two
fixed-width gather-rowsums — numerically identical to the dense
``M = C C^T`` apply, hence identical PCG iteration counts.  The halo
``ppermute`` for t's exchange depends on local t only, and z's interior
gather is independent of the incoming halo, so XLA overlaps the
transfer with the gather-FMA exactly as in parallel/pcg._matvec_halo.

The polynomial wrap q(B), B = C^T A C (models/neural_fsai.py) composes
these with the halo SpMV: every B application is C-apply -> A-halo-SpMV
-> C^T-apply, all neighbor-only communication.

This preconditioner apply is *exact* (global FSAI, not block-truncated),
unlike block-Jacobi (parallel/block_jacobi.py) which drops cross-shard
couplings.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from deeppreconditioning_tpu.utils import struct

from deeppreconditioning_tpu.parallel.pcg import _matvec_halo


@struct.dataclass
class ShardedFSAI:
    """FSAI factor C prepared for an S-way contiguous row partition.

    All leading axes are n_total (shard with PartitionSpec("x")).
    Per-shard relative indices are already baked in:
        u_pos: (n_total, w) — positions into [r_local | right halo | 0]
            for t_j = sum_k C[S_j[k], j] * r[S_j[k]]; sentinel R + halo.
        u_vals: (n_total, w) — C[S_j[k], j].
        l_pos: (n_total, wl) — positions into [left halo | t_local | 0]
            for z_i = sum over pattern slots (j, k) with S_j[k] == i;
            sentinel halo + R.
        l_vals: (n_total, wl) — matching C values.
    ``halo`` (static) is the factor's column row-extent bound; exact
    iff halo <= rows_per_shard (asserted by the builder).
    """

    u_pos: jax.Array
    u_vals: jax.Array
    l_pos: jax.Array
    l_vals: jax.Array
    halo: int = struct.field(pytree_node=False)
    n_shards: int = struct.field(pytree_node=False)

    @property
    def n_total(self) -> int:
        return self.u_pos.shape[0]

    @property
    def rows_per_shard(self) -> int:
        return self.n_total // self.n_shards


def build_sharded_fsai(
    out_rows: np.ndarray,  # (n_pad, w) FSAI row sets (sentinel >= n_pad)
    c_vals: np.ndarray,  # (n_pad, w) factor values (raw space)
    n_shards: int,
    n_total: Optional[int] = None,
) -> ShardedFSAI:
    """Host build: global FSAI columns -> per-shard halo gather plan.

    ``c_vals`` must already be in raw space (scaling folded, padding
    masked — ops/factor_apply.fsai_factor_vals un-raveled)."""
    out_rows = np.asarray(out_rows)
    c_vals = np.asarray(c_vals)
    n_pad, w = out_rows.shape
    if n_total is None:
        n_total = n_pad
    rps = -(-n_total // n_shards)
    n_total = rps * n_shards

    jj = np.broadcast_to(np.arange(n_pad)[:, None], (n_pad, w))
    live = (out_rows < n_pad) & (c_vals != 0)
    ii = np.where(live, out_rows, jj)  # row of each slot
    halo = int(np.maximum(ii - jj, 0).max(initial=0))
    assert halo <= rps, (
        f"factor bandwidth {halo} exceeds shard rows {rps}; "
        f"reduce n_shards or use a single-device apply"
    )
    halo = max(halo, 1)

    # upper pass t_j = sum_k C[i, j] r_i: row index i relative to
    # shard(j)'s start, into [r_local (rps) | right halo (halo) | 0]
    shard_start = (np.arange(n_pad) // rps * rps)[:, None]
    u_pos = np.where(live, ii - shard_start, rps + halo)
    u_vals = np.where(live, c_vals, 0.0)
    assert (u_pos[live] >= 0).all() and (u_pos[live] < rps + halo).all()

    u_pos_full = np.full((n_total, w), rps + halo, np.int32)
    u_vals_full = np.zeros((n_total, w), c_vals.dtype)
    u_pos_full[:n_pad] = u_pos
    u_vals_full[:n_pad] = u_vals

    # lower pass z_i = sum C[i, j] t_j: group slots by row i; column j
    # relative to shard(i)'s start, into [left halo | t_local | 0]
    ri = ii[live].astype(np.int64)
    cj = jj[live].astype(np.int64)
    cv = c_vals[live]
    wl = int(np.bincount(ri, minlength=1).max(initial=1))
    order = np.argsort(ri, kind="stable")
    ri_s, cj_s, cv_s = ri[order], cj[order], cv[order]
    counts = np.bincount(ri_s, minlength=n_total)
    starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
    slot = np.arange(ri_s.shape[0]) - starts[ri_s]
    l_pos_full = np.full((n_total, wl), halo + rps, np.int32)
    l_vals_full = np.zeros((n_total, wl), c_vals.dtype)
    rel = cj_s - (ri_s // rps) * rps + halo
    assert (rel >= 0).all() and (rel < halo + rps).all()
    l_pos_full[ri_s, slot] = rel
    l_vals_full[ri_s, slot] = cv_s

    return ShardedFSAI(
        u_pos=jnp.asarray(u_pos_full),
        u_vals=jnp.asarray(u_vals_full),
        l_pos=jnp.asarray(l_pos_full),
        l_vals=jnp.asarray(l_vals_full),
        halo=halo,
        n_shards=n_shards,
    )


def _ct_local(m, r_local, axis_name):
    """Shard-local t = C^T r with a right halo of r."""
    halo = m["halo"]
    axis_size = jax.lax.axis_size(axis_name)
    left_perm = [(i, (i - 1) % axis_size) for i in range(axis_size)]
    from_right = jax.lax.ppermute(
        r_local[:halo], axis_name, left_perm
    )
    r_ext = jnp.concatenate(
        [r_local, from_right, jnp.zeros((1,), r_local.dtype)]
    )
    return jnp.sum(m["u_vals"] * r_ext[m["u_pos"]], axis=1)


def _c_local(m, t_local, axis_name):
    """Shard-local z = C t with a left halo of t."""
    halo = m["halo"]
    axis_size = jax.lax.axis_size(axis_name)
    right_perm = [(i, (i + 1) % axis_size) for i in range(axis_size)]
    from_left = jax.lax.ppermute(
        t_local[-halo:], axis_name, right_perm
    )
    t_ext = jnp.concatenate(
        [from_left, t_local, jnp.zeros((1,), t_local.dtype)]
    )
    return jnp.sum(m["l_vals"] * t_ext[m["l_pos"]], axis=1)


def make_fsai_sharded_apply(halo: int, axis_name: str = "x"):
    """apply_m for pcg_sharded: z = C (C^T r), exact global FSAI.

    ``m_data`` passed to pcg_sharded must be the dict
    {"u_pos", "u_vals", "l_pos", "l_vals"} of a ShardedFSAI (leading
    axes n_total, sharded by the solver).  ``halo`` is static, hence a
    factory closure (the apply callable itself is a jit-static arg)."""

    def apply_fn(m_local, r_local):
        m = dict(m_local)
        m["halo"] = halo
        t = _ct_local(m, r_local, axis_name)
        return _c_local(m, t, axis_name)

    return apply_fn


def make_fsai_poly_sharded_apply(
    halo: int,
    degree: int,
    a_halo: int,
    n_total: int,
    axis_name: str = "x",
):
    """apply_m for the polynomial-wrapped flagship in sharded form:

        z = C q(B) q(B)^T C^T r,   B = C^T A C

    m_data = {ShardedFSAI arrays..., "q": jnp.tile(q, n_shards),
    "a_cols": (n_total, k), "a_vals": (n_total, k)} — A in ShardedELL
    layout (global columns).  The solver shards every m_data leaf on
    its leading axis, so the (degree+1,) coefficients are tiled per
    shard: each shard's local slice is exactly q.  Every B application
    is neighbor-only communication: C-apply (left halo), halo SpMV,
    C^T-apply (right halo).  q = I reduces to make_fsai_sharded_apply
    exactly."""

    def apply_fn(m_local, r_local):
        m = dict(m_local)
        m["halo"] = halo
        q = m["q"]

        def b_(t):
            y = _matvec_halo(
                m["a_cols"], m["a_vals"], _c_local(m, t, axis_name),
                axis_name, a_halo, n_total,
            )
            return _ct_local(m, y, axis_name)

        def q_(t):
            u = q[degree] * t
            for i in range(degree - 1, -1, -1):
                u = b_(u) + q[i] * t
            return u

        t = q_(q_(_ct_local(m, r_local, axis_name)))
        return _c_local(m, t, axis_name)

    return apply_fn
