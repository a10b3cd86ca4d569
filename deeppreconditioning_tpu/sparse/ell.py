"""ELLPACK sparse matrix — the general static-shape SpMV layout.

FVM pressure-Poisson matrices have a near-uniform ~5-7 nnz per row, so
padding each row to a fixed slot count wastes little and buys fully static,
vectorizable shapes: SpMV becomes `gather + multiply + row-sum`, which XLA
fuses around one gather.

Sentinel convention: empty slots store column index `n` (one past the end)
with value 0; `x` is padded with one trailing zero so gathers stay in
bounds without masks.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from deeppreconditioning_tpu.utils import struct


def csr_to_ell_arrays(csr, n_pad: int, k: int | None = None,
                      sentinel: int | None = None):
    """Vectorized CSR -> padded ELL (cols, vals) host arrays.

    Empty slots get column `sentinel` (default n_pad) and value 0.
    """
    n = csr.shape[0]
    if sentinel is None:
        sentinel = n_pad
    counts = np.diff(csr.indptr)
    kmax = int(counts.max()) if n and csr.nnz else 0
    if k is None:
        k = max(kmax, 1)
    else:
        assert k >= kmax, f"k={k} < max row nnz {kmax}"
    cols = np.full((n_pad, k), sentinel, np.int32)
    vals = np.zeros((n_pad, k), np.float64)
    if csr.nnz:
        row_of = np.repeat(np.arange(n), counts)
        slot = np.arange(csr.nnz) - np.repeat(csr.indptr[:-1], counts)
        cols[row_of, slot] = csr.indices
        vals[row_of, slot] = csr.data
    return cols, vals


@struct.dataclass
class ELLMatrix:
    """Square sparse matrix in padded ELLPACK format.

    Attributes:
        cols: int32 (n_pad, k) — column index per slot; sentinel = n_pad.
        vals: float (n_pad, k) — entry values; 0 in empty slots.
        n: static int — true dimension (rows beyond n are all-sentinel).
    """

    cols: jax.Array
    vals: jax.Array
    n: int = struct.field(pytree_node=False)

    @property
    def n_pad(self) -> int:
        return self.cols.shape[0]

    @property
    def k(self) -> int:
        return self.cols.shape[1]

    @property
    def nnz(self) -> jax.Array:
        return jnp.sum(self.cols != self.n_pad)

    def matvec(self, x: jax.Array) -> jax.Array:
        """y = A @ x via gather + row-sum. x has shape (n_pad,)."""
        x_ext = jnp.concatenate([x, jnp.zeros((1,), x.dtype)])
        gathered = x_ext[self.cols]
        return jnp.sum(self.vals * gathered, axis=1)

    def to_dense(self) -> jax.Array:
        rows = jnp.broadcast_to(
            jnp.arange(self.n_pad)[:, None], self.cols.shape
        )
        out = jnp.zeros((self.n_pad, self.n_pad + 1), self.vals.dtype)
        out = out.at[rows, self.cols].add(self.vals)
        return out[: self.n, : self.n]

    @staticmethod
    def from_coo(
        rows: np.ndarray,
        cols: np.ndarray,
        vals: np.ndarray,
        n: int,
        n_pad: int | None = None,
        k: int | None = None,
        dtype=jnp.float32,
    ) -> "ELLMatrix":
        """Build from host COO triplets (duplicates summed)."""
        import scipy.sparse as sp

        csr = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
        csr.sum_duplicates()
        if n_pad is None:
            n_pad = ((n + 7) // 8) * 8
        assert n_pad >= n
        ell_cols, ell_vals = csr_to_ell_arrays(csr, n_pad, k)
        return ELLMatrix(
            cols=jnp.asarray(ell_cols),
            vals=jnp.asarray(ell_vals, dtype=dtype),
            n=n,
        )

    @staticmethod
    def from_scipy(mat, n_pad: int | None = None, k: int | None = None,
                   dtype=jnp.float32) -> "ELLMatrix":
        coo = mat.tocoo()
        return ELLMatrix.from_coo(
            coo.row, coo.col, coo.data, mat.shape[0], n_pad=n_pad, k=k,
            dtype=dtype,
        )
