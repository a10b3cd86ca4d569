"""Batched COO sparse tensor — the framework's exchange format.

JAX equivalent of spconv's ``SparseConvTensor`` (reference:
uibk/deep_preconditioning/data_set.py:121-125): a batch of sparse 2-D
"images" (here: matrices) stored as one flat list of ``(batch, row, col)``
index triplets with per-entry feature vectors.

Differences from the reference, driven by XLA's compilation model:
  * nnz is padded to a static bucket; a boolean ``valid`` mask marks real
    entries.  Padded entries carry index (0, 0, 0) and value 0, and every op
    masks before scattering, so padding is inert.
  * immutable pytree (utils/struct.py) — functional transforms compose.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from deeppreconditioning_tpu.utils import struct


def pad_to_bucket(n: int, bucket: int = 256) -> int:
    """Round up to a multiple of `bucket` (>= bucket) for static shapes."""
    if n <= 0:
        return bucket
    return ((n + bucket - 1) // bucket) * bucket


@struct.dataclass
class BatchedCOO:
    """A batch of sparse matrices in padded COO format.

    Attributes:
        indices: int32 (nnz_pad, 3) — columns are (batch, row, col).
        values: float (nnz_pad,) or (nnz_pad, C) — entry values / features.
        valid: bool (nnz_pad,) — True for real entries.
        batch_size: static int.
        spatial_shape: static (H, W) — dense shape of each matrix.
    """

    indices: jax.Array
    values: jax.Array
    valid: jax.Array
    batch_size: int = struct.field(pytree_node=False)
    spatial_shape: Tuple[int, int] = struct.field(pytree_node=False)

    @property
    def nnz_pad(self) -> int:
        return self.indices.shape[0]

    @property
    def n(self) -> int:
        return self.spatial_shape[0]

    def replace_values(self, values: jax.Array) -> "BatchedCOO":
        """Return a copy with new values (masked by `valid`)."""
        mask = self.valid
        if values.ndim > 1:
            mask = mask[:, None]
        return self.replace(values=jnp.where(mask, values, 0))

    def masked_values(self) -> jax.Array:
        mask = self.valid if self.values.ndim == 1 else self.valid[:, None]
        return jnp.where(mask, self.values, 0)

    def to_dense(self) -> jax.Array:
        """Scatter to a dense (B, H, W) array (scalar values only)."""
        vals = self.masked_values()
        if vals.ndim > 1:
            vals = vals[..., 0]
        b, r, c = self.indices[:, 0], self.indices[:, 1], self.indices[:, 2]
        out = jnp.zeros((self.batch_size, *self.spatial_shape), vals.dtype)
        return out.at[b, r, c].add(vals)

    @staticmethod
    def from_numpy(
        indices: np.ndarray,
        values: np.ndarray,
        batch_size: int,
        spatial_shape: Tuple[int, int],
        bucket: int = 256,
        dtype=jnp.float32,
    ) -> "BatchedCOO":
        """Build from host arrays, padding nnz to a bucket."""
        nnz = indices.shape[0]
        nnz_pad = pad_to_bucket(nnz, bucket)
        idx = np.zeros((nnz_pad, 3), np.int32)
        idx[:nnz] = indices
        if values.ndim == 1:
            val = np.zeros((nnz_pad,), np.float64)
        else:
            val = np.zeros((nnz_pad, values.shape[1]), np.float64)
        val[:nnz] = values
        valid = np.zeros((nnz_pad,), bool)
        valid[:nnz] = True
        return BatchedCOO(
            indices=jnp.asarray(idx),
            values=jnp.asarray(val, dtype=dtype),
            valid=jnp.asarray(valid),
            batch_size=batch_size,
            spatial_shape=tuple(spatial_shape),
        )


def batched_coo_matvec(
    coo: BatchedCOO, vectors: jax.Array, transpose: bool = False
) -> jax.Array:
    """Batched sparse matrix–vector product: out[b] = A_b @ vectors[b].

    Semantics contract = reference ``sparse_matvec_mul``
    (uibk/deep_preconditioning/utils.py:15-43): gather vector entries by
    column index, multiply by entry values, segment-sum into rows — but as a
    single fused scatter-add over the whole batch instead of a per-sample
    Python loop (XLA turns this into one sorted segment reduction).

    Args:
        coo: batch of matrices, scalar or (nnz, 1) features.
        vectors: (B, n) batch of vectors.
        transpose: multiply with A_b^T instead.
    """
    vals = coo.masked_values()
    if vals.ndim > 1:
        vals = vals[..., 0]
    b = coo.indices[:, 0]
    r = coo.indices[:, 2 if transpose else 1]
    c = coo.indices[:, 1 if transpose else 2]
    prods = vals * vectors[b, c]
    out = jnp.zeros_like(vectors)
    return out.at[b, r].add(prods)
