"""Block-Jacobi incomplete-Cholesky preconditioning for distributed PCG.

The distributed triangular apply of SURVEY.md §2.4 item 4: each shard
factors its own diagonal block A_ss with IC(0) and applies
z_s = L_s^-T L_s^-1 r_s locally — no communication in the apply, which
is what makes it the scalable preconditioner for row-partitioned PCG
(the off-diagonal coupling is dropped, trading iterations for perfectly
parallel applies).

The per-shard solves use the Neumann/Jacobi-sweep form
(ops/trisolve.py), so the whole apply is fixed-trip SpMVs — no level
schedules, no data-dependent control flow, identical cost on every
shard.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp
from deeppreconditioning_tpu.utils import struct

from deeppreconditioning_tpu.ops.ic0 import ic0_factor
from deeppreconditioning_tpu.ops.trisolve import (
    TriNeumann,
    neumann_ic_apply,
)


@struct.dataclass
class BlockJacobiIC:
    """Stacked per-shard Neumann IC operators (flat (n_total, k) layout,
    column indices *local to each shard* with sentinel = rows_per_shard).
    """

    cols: jnp.ndarray
    vals: jnp.ndarray
    inv_diag: jnp.ndarray
    sweeps: int = struct.field(pytree_node=False)
    rows_per_shard: int = struct.field(pytree_node=False)


def build_block_jacobi_ic(
    a: sp.spmatrix,
    n_shards: int,
    n_total: int,
    sweeps: int = 8,
) -> BlockJacobiIC:
    """Factor the diagonal blocks of the row partition with IC(0).

    Args:
        a: the full matrix (host scipy).
        n_shards: shard count; n_total the padded global length
            (n_total % n_shards == 0, matching parallel.partition).
        sweeps: Jacobi sweeps per triangular solve (exact when >= the
            block's level count).
    """
    assert n_total % n_shards == 0
    r = n_total // n_shards
    n = a.shape[0]
    csr = a.tocsr()

    k_max = 1
    per_shard = []
    for s in range(n_shards):
        lo, hi = s * r, min((s + 1) * r, n)
        if lo >= n:
            per_shard.append(None)
            continue
        block = csr[lo:hi, lo:hi]
        l = ic0_factor(block)
        strict = sp.tril(l, k=-1).tocsr()
        k_max = max(k_max, int(np.diff(strict.indptr).max() or 0))
        per_shard.append((l, strict))

    cols = np.full((n_total, k_max), r, np.int32)
    vals = np.zeros((n_total, k_max), np.float64)
    inv_diag = np.zeros(n_total)
    for s, entry in enumerate(per_shard):
        if entry is None:
            continue
        l, strict = entry
        base = s * r
        m = l.shape[0]
        inv_diag[base: base + m] = 1.0 / l.diagonal()
        for i in range(m):
            lo_i, hi_i = strict.indptr[i], strict.indptr[i + 1]
            cols[base + i, : hi_i - lo_i] = strict.indices[lo_i:hi_i]
            vals[base + i, : hi_i - lo_i] = strict.data[lo_i:hi_i]

    return BlockJacobiIC(
        cols=jnp.asarray(cols),
        vals=jnp.asarray(vals),
        inv_diag=jnp.asarray(inv_diag),
        sweeps=sweeps,
        rows_per_shard=r,
    )


def block_jacobi_apply(m_local: BlockJacobiIC, r_local):
    """Shard-local z = L_s^-T L_s^-1 r_s (call inside shard_map)."""
    op = TriNeumann(
        cols=m_local.cols,
        vals=m_local.vals,
        inv_diag=m_local.inv_diag,
        sweeps=m_local.sweeps,
        n=m_local.rows_per_shard,
    )
    return neumann_ic_apply(op, r_local)
