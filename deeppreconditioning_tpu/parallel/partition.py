"""Row partitioning of sparse matrices over a device mesh.

The "tensor parallelism" of sparse linear algebra (SURVEY.md §2.4 item 2):
a 1-D row partition of the ELL matrix across chips.  Column indices stay
*global*; the distributed matvec either all-gathers x (general matrices,
small n) or exchanges fixed-width halos with mesh neighbors (banded
matrices — FVM/Poisson — where the bandwidth bound makes neighbor-only
communication exact).

Layout: flat (n_total, k) arrays with n_total divisible by the shard
count; sharding the leading axis with ``PartitionSpec("x")`` gives every
device its contiguous row block.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from deeppreconditioning_tpu.utils import struct

from deeppreconditioning_tpu.sparse.ell import ELLMatrix


@struct.dataclass
class ShardedELL:
    """ELL matrix prepared for an S-way 1-D row partition.

    Attributes:
        cols: int32 (n_total, k) global column indices; sentinel n_total.
        vals: (n_total, k) values.
        n: static true dimension (n <= n_total; trailing rows empty).
        n_shards: static shard count (n_total % n_shards == 0).
        halo: static matrix bandwidth max|col - row| — halo-exchange
            matvec is exact iff halo <= rows_per_shard.
    """

    cols: jax.Array
    vals: jax.Array
    n: int = struct.field(pytree_node=False)
    n_shards: int = struct.field(pytree_node=False)
    halo: int = struct.field(pytree_node=False)

    @property
    def n_total(self) -> int:
        return self.cols.shape[0]

    @property
    def rows_per_shard(self) -> int:
        return self.n_total // self.n_shards


def shard_ell_rows(ell: ELLMatrix, n_shards: int) -> ShardedELL:
    """Prepare an ELLMatrix for an `n_shards`-way row partition (host).

    Pads rows so shards are equal, remaps the sentinel column from
    ell.n_pad to the new padded size, and measures the bandwidth.
    """
    cols = np.asarray(ell.cols)
    vals = np.asarray(ell.vals)
    n_pad, k = cols.shape
    rows_per_shard = -(-n_pad // n_shards)
    n_total = rows_per_shard * n_shards

    cols_full = np.full((n_total, k), n_total, cols.dtype)
    vals_full = np.zeros((n_total, k), vals.dtype)
    cols_full[:n_pad] = np.where(cols == ell.n_pad, n_total, cols)
    vals_full[:n_pad] = vals

    real = cols_full < n_total
    if real.any():
        rows_idx = np.broadcast_to(
            np.arange(n_total)[:, None], cols_full.shape
        )
        halo = int(np.abs(cols_full[real] - rows_idx[real]).max())
    else:
        halo = 0

    return ShardedELL(
        cols=jnp.asarray(cols_full),
        vals=jnp.asarray(vals_full),
        n=ell.n,
        n_shards=n_shards,
        halo=halo,
    )


def pad_vector(x: np.ndarray, n_total: int) -> np.ndarray:
    """Zero-pad a global vector to the sharded length."""
    out = np.zeros((n_total,), x.dtype)
    out[: x.shape[0]] = x
    return out
