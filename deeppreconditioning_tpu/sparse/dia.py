"""DIA (diagonal) sparse format — the zero-gather SpMV layout.

FVM pressure-Poisson matrices on structured orderings are *banded*: all
nonzeros live on a handful of fixed diagonal offsets (5 for 2-D, 7 for
3-D grids).  Storing one value array per offset turns SpMV into

    y[i] = sum_d  vals[d][i] * x[i + off_d]

— contiguous shifted reads and fused multiply-adds, no gather at all.
The matvec is purely HBM-bandwidth-bound (read vals + x, write y) at
0.5 flop/byte.  ``DIAMatrix.matvec`` is the one implementation: XLA
fuses it into a single streaming loop (no hand-written kernel beats it
by more than the margin to a plain copy — PERF.md, "Kernel decisions").
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from deeppreconditioning_tpu.utils import struct


@struct.dataclass
class DIAMatrix:
    """Square banded matrix as per-offset diagonal value arrays.

    Attributes:
        vals: (n_diag, n_pad) — vals[d, i] multiplies x[i + offsets[d]];
            zero where i + offset is out of range.
        offsets: static tuple of diagonal offsets (can be negative).
        n: static true dimension (n_pad rows padded with zeros).
    """

    vals: jax.Array
    offsets: Tuple[int, ...] = struct.field(pytree_node=False)
    n: int = struct.field(pytree_node=False)

    @property
    def n_pad(self) -> int:
        return self.vals.shape[1]

    @property
    def halo(self) -> int:
        return max(abs(o) for o in self.offsets) if self.offsets else 0

    def to_scipy(self):
        """Exact scipy CSR of the true n x n matrix.

        NOTE the convention difference vs scipy.sparse.diags: our
        vals[d, i] multiplies x[i + off] (indexed by ROW), while scipy
        indexes diagonal data by COLUMN — feeding vals straight into
        sp.diags misaligns every off-diagonal and produces an
        asymmetric matrix at grid boundaries."""
        import scipy.sparse as sp

        v = np.asarray(self.vals)
        rows, cols, data = [], [], []
        for d, off in enumerate(self.offsets):
            i0, i1 = max(0, -off), min(self.n, self.n - off)
            if i1 <= i0:
                continue
            i = np.arange(i0, i1)
            rows.append(i)
            cols.append(i + off)
            data.append(v[d, i0:i1])
        m = sp.csr_matrix(
            (np.concatenate(data),
             (np.concatenate(rows), np.concatenate(cols))),
            shape=(self.n, self.n),
        )
        m.eliminate_zeros()
        return m

    def matvec(self, x: jax.Array) -> jax.Array:
        """y = A @ x via static shifted slices (pure XLA)."""
        h = self.halo
        x_ext = jnp.pad(x, (h, h))
        y = jnp.zeros_like(x)
        for d, off in enumerate(self.offsets):
            y = y + self.vals[d] * jax.lax.dynamic_slice(
                x_ext, (h + off,), (self.n_pad,)
            )
        return y

    def to_dense(self) -> jax.Array:
        n = self.n
        out = jnp.zeros((n, n), self.vals.dtype)
        idx = jnp.arange(n)
        for d, off in enumerate(self.offsets):
            cols = idx + off
            ok = (cols >= 0) & (cols < n)
            out = out.at[idx[ok], cols[ok]].add(self.vals[d, :n][ok])
        return out

    @staticmethod
    def from_scipy(mat, n_pad: int | None = None,
                   dtype=jnp.float32) -> "DIAMatrix":
        dia = mat.todia()
        n = mat.shape[0]
        if n_pad is None:
            n_pad = ((n + 1023) // 1024) * 1024
        offsets = tuple(int(o) for o in dia.offsets)
        vals = np.zeros((len(offsets), n_pad), np.float64)
        # scipy DIA: data[d, j] sits at column j, row j - offset.
        # Our convention: vals[d, i] * x[i + off] with i the row, so
        # vals[d, i] = A[i, i + off] = dia.data[d, i + off].
        for d, off in enumerate(offsets):
            col = np.arange(n) + off
            ok = (col >= 0) & (col < n)
            vals[d, np.arange(n)[ok]] = dia.data[d][col[ok]]
        return DIAMatrix(
            vals=jnp.asarray(vals, dtype=dtype), offsets=offsets, n=n
        )


def poisson_dia(shape: Tuple[int, ...], dtype=jnp.float32,
                n_pad: int | None = None) -> DIAMatrix:
    """Standard 5/7-point Poisson operator on a 2-D/3-D grid as DIA.

    The synthetic kernel-benchmark family from BASELINE.md ("3D 7-point
    Poisson ladder 64^3 -> 256^3").  Dirichlet boundaries: off-diagonal
    links crossing a grid face are dropped, diagonal stays 2*ndim.
    """
    ndim = len(shape)
    n = int(np.prod(shape))
    if n_pad is None:
        n_pad = ((n + 1023) // 1024) * 1024
    strides = [int(np.prod(shape[i + 1:])) for i in range(ndim)]
    offsets = []
    for s in strides:
        offsets += [-s, s]
    offsets = tuple(sorted(offsets)) + (0,)
    offsets = tuple(sorted(set(offsets)))

    vals = np.zeros((len(offsets), n_pad), np.float64)
    idx = np.arange(n)
    coords = np.unravel_index(idx, shape)
    for d, off in enumerate(offsets):
        if off == 0:
            vals[d, :n] = 2.0 * ndim
            continue
        axis = strides.index(abs(off))
        if off < 0:
            ok = coords[axis] > 0
        else:
            ok = coords[axis] < shape[axis] - 1
        vals[d, idx[ok]] = -1.0
    return DIAMatrix(
        vals=jnp.asarray(vals, dtype=dtype), offsets=offsets, n=n
    )
