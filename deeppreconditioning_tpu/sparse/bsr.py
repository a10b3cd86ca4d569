"""BSR (block-sparse-row) matrix — the dense-tile path for unstructured
sparsity.

ELL/DIA are elementwise streams; for matrices without banded structure
block sparsity groups nonzeros into dense (block_size x block_size)
tiles so the hot loop is small matmuls over a block index list (the
same machinery as block-sparse attention kernels).  Fill-in from blocking is the usual trade: FVM
matrices with bandwidth-local orderings block well.

Layout (ELL-of-blocks, static shapes): ``blocks`` is
(n_block_rows, slots, bs, bs) and ``block_cols`` (n_block_rows, slots)
holds block-column ids with sentinel = n_block_cols pointing at a zero
x-block.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from deeppreconditioning_tpu.utils import struct


@struct.dataclass
class BSRMatrix:
    """Square block-sparse matrix with fixed block slots per block-row.

    Attributes:
        blocks: (R, S, bs, bs) dense blocks.
        block_cols: int32 (R, S); sentinel R points at the zero block of
            the padded x.
        n: static true dimension (R * bs >= n).
    """

    blocks: jax.Array
    block_cols: jax.Array
    n: int = struct.field(pytree_node=False)

    @property
    def block_size(self) -> int:
        return self.blocks.shape[2]

    @property
    def n_block_rows(self) -> int:
        return self.blocks.shape[0]

    @property
    def slots(self) -> int:
        return self.blocks.shape[1]

    @property
    def n_pad(self) -> int:
        return self.n_block_rows * self.block_size

    def matvec(self, x: jax.Array) -> jax.Array:
        """Reference XLA path: gather x blocks, batched matmul, sum."""
        bs = self.block_size
        xb = jnp.concatenate(
            [x.reshape(-1, bs), jnp.zeros((1, bs), x.dtype)]
        )
        gathered = xb[self.block_cols]  # (R, S, bs)
        return jnp.einsum(
            "rsij,rsj->ri", self.blocks, gathered,
            precision=jax.lax.Precision.HIGHEST,
        ).reshape(-1)

    @staticmethod
    def from_scipy(mat, block_size: int = 128, slots: int | None = None,
                   dtype=jnp.float32) -> "BSRMatrix":
        import scipy.sparse as sp

        n = mat.shape[0]
        bs = block_size
        r = -(-n // bs)
        padded = sp.csr_matrix((r * bs, r * bs))
        csr = mat.tocsr()
        padded = sp.bmat(
            [[csr, None], [None, sp.eye(r * bs - n) * 0]]
        ).tocsr() if r * bs > n else csr
        bsr = padded.tobsr((bs, bs))
        indptr, indices = bsr.indptr, bsr.indices
        row_counts = np.diff(indptr)
        max_slots = int(row_counts.max()) if r else 1
        if slots is None:
            slots = max(max_slots, 1)
        assert slots >= max_slots
        blocks = np.zeros((r, slots, bs, bs), np.float64)
        cols = np.full((r, slots), r, np.int32)
        for i in range(r):
            lo, hi = indptr[i], indptr[i + 1]
            cols[i, : hi - lo] = indices[lo:hi]
            blocks[i, : hi - lo] = bsr.data[lo:hi]
        return BSRMatrix(
            blocks=jnp.asarray(blocks, dtype),
            block_cols=jnp.asarray(cols),
            n=n,
        )
