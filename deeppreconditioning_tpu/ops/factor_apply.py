"""Sparse factored-preconditioner apply: z = L (L^T r) as pure gathers.

The reference applies the learned preconditioner as a *dense* matvec
``z = M @ r`` with ``M = L L^T`` materialized in setup
(uibk/deep_preconditioning/test.py:100-105, cg.py:81).  That costs
an n^3 matmul per setup plus an n^2 dense matvec per CG iteration even
though L lives on a sparse, statically known pattern (the conv-dilated
tril sites).  This module keeps the preconditioner in factor form:

  * host side, a ``FactorApplyPlan`` is precomputed from the pattern —
    for every output row a fixed-width (dataset-global, static) list of
    (value-index, vector-index) pairs for the L and L^T halves;
  * device side, ``factor_apply`` is two gather-multiply-rowsum ops:
    ``t = L^T r`` then ``z = L t`` — no scatter, no dense matrix, and the
    net's output value vector is used *in place* (setup = model forward
    only).

Padding entries point at a sentinel value slot holding 0, so they are
inert; mathematically the apply equals the reference's ``(L L^T) @ r``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from deeppreconditioning_tpu.utils import struct


@struct.dataclass
class FactorApplyPlan:
    """Static gather plan for z = L (L^T r) over one L pattern.

    Shapes: l_* are (n_pad, w_lower); u_* are (n_pad, w_upper).
    ``l_src``/``u_src`` index into the zero-extended value vector
    (sentinel = nnz_pad); ``l_col``/``u_row`` index the vector operand.
    """

    l_src: jax.Array
    l_col: jax.Array
    u_src: jax.Array
    u_row: jax.Array

    @property
    def n_pad(self) -> int:
        return self.l_src.shape[0]


def _group_fixed_width(
    group: np.ndarray,
    payload_src: np.ndarray,
    payload_idx: np.ndarray,
    n_groups: int,
    width: int,
    sentinel: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Pack (group -> [(src, idx), ...]) into fixed-width row-major
    arrays, vectorized (no per-row Python loop)."""
    order = np.argsort(group, kind="stable")
    group_s = group[order]
    counts = np.bincount(group_s, minlength=n_groups)
    if counts.size and counts.max(initial=0) > width:
        raise ValueError(
            f"row width {counts.max()} exceeds static width {width}"
        )
    starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
    slot = np.arange(group_s.shape[0]) - starts[group_s]
    src = np.full((n_groups, width), sentinel, np.int32)
    idx = np.zeros((n_groups, width), np.int32)
    src[group_s, slot] = payload_src[order]
    idx[group_s, slot] = payload_idx[order]
    return src, idx


def pattern_widths(
    rows: np.ndarray, cols: np.ndarray, valid: np.ndarray
) -> Tuple[int, int]:
    """(max nnz per row, max nnz per column) of a pattern — used to pick
    dataset-global static widths so one compiled apply serves all cases."""
    r = rows[valid]
    c = cols[valid]
    w_l = int(np.bincount(r).max(initial=1))
    w_u = int(np.bincount(c).max(initial=1))
    return w_l, w_u


def build_factor_apply_plan(
    rows: np.ndarray,
    cols: np.ndarray,
    valid: np.ndarray,
    n_pad: int,
    widths: Optional[Tuple[int, int]] = None,
) -> FactorApplyPlan:
    """Build the gather plan for one L pattern (host, numpy).

    Args:
        rows, cols: (nnz_pad,) site coordinates of L's value vector (the
            final conv plan's sites — padding entries have valid=False).
        valid: (nnz_pad,) real-site mask.
        n_pad: padded system dimension.
        widths: static (w_lower, w_upper); defaults to this pattern's own
            maxima (pass dataset-global maxima to share one executable).
    """
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    valid = np.asarray(valid)
    sentinel = rows.shape[0]
    if widths is None:
        widths = pattern_widths(rows, cols, valid)
    w_l, w_u = widths
    idx = np.flatnonzero(valid).astype(np.int32)
    r = rows[idx].astype(np.int64)
    c = cols[idx].astype(np.int64)
    # z_i = sum_j L_ij t_j : group by row, gather t at col
    l_src, l_col = _group_fixed_width(
        r, idx, cols[idx].astype(np.int32), n_pad, w_l, sentinel
    )
    # t_j = sum_i L_ij r_i : group by col, gather r at row
    u_src, u_row = _group_fixed_width(
        c, idx, rows[idx].astype(np.int32), n_pad, w_u, sentinel
    )
    return FactorApplyPlan(
        l_src=jnp.asarray(l_src),
        l_col=jnp.asarray(l_col),
        u_src=jnp.asarray(u_src),
        u_row=jnp.asarray(u_row),
    )


def factor_apply(plan: FactorApplyPlan, vals: jax.Array, r: jax.Array
                 ) -> jax.Array:
    """z = L (L^T r) with L given by (plan, vals).

    ``vals`` is the L value vector in the plan's site order (length
    nnz_pad); padding/masked entries must be zero.  Equals the
    reference's dense ``(L L^T) @ r`` (test.py:105, cg.py:81).
    """
    vals_ext = jnp.concatenate(
        [vals, jnp.zeros((1,), vals.dtype)]
    )
    t = jnp.sum(vals_ext[plan.u_src] * r[plan.u_row], axis=1)
    return jnp.sum(vals_ext[plan.l_src] * t[plan.l_col], axis=1)


def factor_normal_apply(m_data, r: jax.Array) -> jax.Array:
    """Suite-compatible apply: m_data = (FactorApplyPlan, vals)."""
    plan, vals = m_data
    return factor_apply(plan, vals, r)


# -- FSAI factor form (ops/fsai.py columns -> gather apply) -------------------

def build_fsai_factor_plan(
    out_rows: np.ndarray,  # (n_pad, w) FSAI plan row sets (sentinel n_pad)
    n_pad: int,
    widths: Optional[Tuple[int, int]] = None,
) -> FactorApplyPlan:
    """FactorApplyPlan over an FSAI column pattern.

    The FSAI value vector is the row-major raveled (n_pad, w) column
    values (ops/fsai.fsai_values / range_fsai_columns): entry
    j*w + k holds C[S_j[k], j].  This kills the dense n^2
    materialization of M = C C^T (bench/suite round-1 weakness #2):
    the apply is z = C (C^T r) as two fixed-width gather-rowsum ops.
    """
    out_rows = np.asarray(out_rows)
    n, w = out_rows.shape
    assert n == n_pad
    rows = out_rows.reshape(-1).astype(np.int64)
    cols = np.repeat(np.arange(n_pad, dtype=np.int64), w)
    valid = rows < n_pad
    rows = np.where(valid, rows, 0)
    return build_factor_apply_plan(
        rows.astype(np.int32), cols.astype(np.int32), valid, n_pad,
        widths=widths,
    )


def fsai_factor_vals(
    out_rows: jax.Array,  # (n_pad, w)
    c_vals: jax.Array,  # (n_pad, w) scaled-space column values
    d_isqrt: Optional[jax.Array] = None,
    n0=None,
) -> jax.Array:
    """Effective raw-space factor values C_eff = D^-1/2 C~, raveled to
    the build_fsai_factor_plan value order, padding masked.

    With C_eff the polynomial inner operator satisfies
    B~ = C_eff^T A C_eff for the RAW A (the D factors cancel), so the
    factor-form polynomial apply needs only the raw SpMV.
    """
    n_pad, w = c_vals.shape
    vals = c_vals
    safe_rows = jnp.minimum(out_rows, n_pad - 1)
    if d_isqrt is not None:
        vals = vals * d_isqrt.astype(vals.dtype)[safe_rows]
    live = out_rows < n_pad
    if n0 is not None:
        live = live & (safe_rows < n0) & (
            jnp.arange(n_pad)[:, None] < n0
        )
    return jnp.where(live, vals, 0.0).reshape(-1)


def make_fsai_poly_apply(matvec, degree: int):
    """Factory for the polynomial-wrapped FSAI apply in factor form:

        z = C q(B) q(B)^T C^T r,   B = C^T A C

    The returned function has the suite's apply signature
    ``(m_data, r) -> z`` with m_data = (plan: FactorApplyPlan, vals,
    q_coeffs, a_data) — a pure-array pytree, jit-safe.  ``matvec`` (the
    raw-system SpMV, e.g. batched_coo_matvec) and the polynomial degree
    are Python-static, so they live in the closure, not the pytree; one
    compiled executable is produced per (matvec, degree) pair.

    Each B application is one sparse matvec bracketed by the two
    fixed-width gathers — the scalable (and shard-local-friendly)
    equivalent of ops/fsai.poly_preconditioner_dense.  q = I (coeffs
    [1]) reduces to plain z = C (C^T r).
    """

    def apply_fn(m_data, r: jax.Array) -> jax.Array:
        plan, vals, q_coeffs, a_data = m_data
        vals_ext = jnp.concatenate([vals, jnp.zeros((1,), vals.dtype)])

        def c_t(x):  # C^T x
            return jnp.sum(vals_ext[plan.u_src] * x[plan.u_row], axis=1)

        def c_(t):  # C t
            return jnp.sum(vals_ext[plan.l_src] * t[plan.l_col], axis=1)

        def b_(t):  # B t = C^T A C t
            return c_t(matvec(a_data, c_(t)))

        def q_(t):  # q(B) t by Horner
            u = q_coeffs[degree] * t
            for i in range(degree - 1, -1, -1):
                u = b_(u) + q_coeffs[i] * t
            return u

        return c_(q_(q_(c_t(r))))

    return apply_fn
