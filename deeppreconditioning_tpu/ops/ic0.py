"""Incomplete Cholesky factorizations — native baseline preconditioners.

Replaces the reference's external C++ ``ilupp`` dependency
(uibk/deep_preconditioning/test.py:81-93 uses ``ilupp.ichol0`` /
``ilupp.icholt``).  The factorization itself is a sequential sparse
host-side *setup* step (not a device workload); the hot path — applying
the preconditioner inside PCG — runs on device via the level-scheduled
triangular solves in ops/trisolve.py, or as an SpMV with the materialized
M = L L^T (the reference's apply convention, test.py:88).

Note the reference applies the IC preconditioner as ``z = M r`` with
``M = C C^T ~ A`` (test.py:81-88 + cg.py:81), which preconditions with an
approximation of A rather than A^{-1} — the likely cause of the
"unstable" flag at test.py:46.  This module provides the mathematically
correct apply (two triangular solves) as the default, and the
reference-compatible variant for benchmark parity.

A C++ implementation (native/) accelerates factorization; this numpy
version is the always-available fallback and the reference semantics.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def ic0_factor(a: sp.spmatrix) -> sp.csr_matrix:
    """IC(0): lower-triangular L with the sparsity of tril(A), L L^T ~ A.

    Up-looking algorithm; breakdown (non-positive pivot) is handled the
    standard way by shifting the diagonal and restarting (Manteuffel
    shift), so the factorization always succeeds for SPD input patterns.
    """
    csr = sp.tril(a.tocsr(), format="csr")
    n = csr.shape[0]
    indptr, indices, data = csr.indptr, csr.indices, csr.data

    from deeppreconditioning_tpu import native

    use_native = native.available()
    alpha = 0.0
    diag = csr.diagonal()
    base = np.abs(diag).max() if n else 1.0
    for _attempt in range(40):
        ldata = data.astype(np.float64).copy()
        if alpha:
            for i in range(n):
                # diagonal entry is the last in each tril CSR row
                ldata[indptr[i + 1] - 1] += alpha * base
        if use_native:
            ok = native.ic0(indptr, indices, ldata) == 0
        else:
            ok = _ic0_inplace(n, indptr, indices, ldata)
        if ok:
            return sp.csr_matrix((ldata, indices, indptr), shape=(n, n))
        alpha = max(2 * alpha, 1e-8)
    raise RuntimeError("IC(0) failed even with diagonal shift")


def _ic0_inplace(n, indptr, indices, data) -> bool:
    """Row-wise IC(0) on tril CSR (diagonal last per row). Returns False
    on pivot breakdown."""
    # build a per-row dict view for L(j, :) lookups
    row_maps = []
    for i in range(n):
        lo, hi = indptr[i], indptr[i + 1]
        row_maps.append(dict(zip(indices[lo:hi].tolist(),
                                 range(lo, hi))))
    for i in range(n):
        lo, hi = indptr[i], indptr[i + 1]
        cols_i = indices[lo:hi]
        for idx in range(lo, hi):
            j = indices[idx]
            s = data[idx]
            # s -= sum_k L[i,k] L[j,k] for k < j in both patterns
            mi = row_maps[i]
            for k, pos_jk in row_maps[j].items():
                if k >= j:
                    continue
                pos_ik = mi.get(k)
                if pos_ik is not None:
                    s -= data[pos_ik] * data[pos_jk]
            if j < i:
                djj = data[indptr[j + 1] - 1]
                data[idx] = s / djj
            else:  # j == i, diagonal (last entry)
                if s <= 0:
                    return False
                data[idx] = np.sqrt(s)
        del cols_i
    return True


def ict_factor(a: sp.spmatrix, add_fill_in: int = 1,
               threshold: float = 0.1) -> sp.csr_matrix:
    """ICT: incomplete Cholesky with threshold dropping and limited fill.

    Mirrors the knobs of ``ilupp.icholt(add_fill_in=, threshold=)``
    (test.py:81-88): per row, entries with |l_ij| below threshold * row
    norm are dropped and at most (nnz_row(A) + add_fill_in) survive.

    Uses the sparse left-looking native C++ ICT (native/src/dptpu.cpp)
    when built; otherwise a dense left-looking numpy fallback adequate
    for the reference's n <~ 5k regime.
    """
    from deeppreconditioning_tpu import native

    if native.available():
        full = a.tocsr()
        full.sum_duplicates()
        full.sort_indices()
        l_indptr, l_indices, l_data = native.ict(
            full.indptr.astype(np.int64), full.indices,
            full.data.astype(np.float64), add_fill_in, threshold,
        )
        return sp.csr_matrix(
            (l_data, l_indices, l_indptr), shape=full.shape
        )

    csr = sp.tril(a.tocsr(), format="csr")
    n = csr.shape[0]
    nnz_row = np.diff(csr.indptr)
    dense = csr.toarray()
    dense = dense + np.tril(dense, -1).T  # full symmetric A
    l_out = np.zeros((n, n))
    for i in range(n):
        for j in range(i):
            if l_out[j, j] == 0:
                continue
            lij = dense[i, j] - l_out[i, :j] @ l_out[j, :j]
            l_out[i, j] = lij / l_out[j, j]
        # threshold dropping + fill cap on the strictly-lower part
        row = l_out[i, :i]
        norm = np.linalg.norm(row)
        if norm > 0:
            row[np.abs(row) < threshold * norm] = 0.0
            budget = int(nnz_row[i]) + add_fill_in
            nz = np.nonzero(row)[0]
            if nz.size > budget:
                keep = nz[np.argsort(-np.abs(row[nz]))[:budget]]
                mask = np.ones(i, bool)
                mask[keep] = False
                row[mask] = 0.0
        pivot = dense[i, i] - row @ row
        l_out[i, i] = np.sqrt(max(pivot, 1e-12))
    return sp.csr_matrix(np.tril(l_out))


def jacobi_preconditioner(a: sp.spmatrix) -> np.ndarray:
    """Inverse-diagonal vector (test.py:74-79)."""
    d = a.tocsr().diagonal()
    return 1.0 / d


def materialize_normal(l_factor: sp.spmatrix) -> sp.csr_matrix:
    """M = L L^T as CSR — the reference's IC apply convention
    (test.py:88: returns (C @ C.T) used as z = M r)."""
    lf = l_factor.tocsr()
    return (lf @ lf.T).tocsr()
