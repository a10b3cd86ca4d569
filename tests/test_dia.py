"""DIA container tests: matvec, dense/scipy round trips, Poisson
builders."""

import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from deeppreconditioning_tpu.sparse.dia import DIAMatrix, poisson_dia


def _poisson_2d_scipy(nx):
    ident = sp.eye(nx)
    t = sp.diags(
        [-np.ones(nx - 1), 2.0 * np.ones(nx), -np.ones(nx - 1)],
        [-1, 0, 1],
    )
    return (sp.kron(ident, t) + sp.kron(t, ident)).tocsr()


def test_dia_from_scipy_matvec():
    a = _poisson_2d_scipy(12)
    dia = DIAMatrix.from_scipy(a, dtype=jnp.float64)
    rng = np.random.default_rng(0)
    x = np.zeros(dia.n_pad)
    x[: a.shape[0]] = rng.standard_normal(a.shape[0])
    y = np.asarray(dia.matvec(jnp.asarray(x)))
    np.testing.assert_allclose(y[: a.shape[0]], a @ x[: a.shape[0]],
                               rtol=1e-12)
    np.testing.assert_allclose(y[a.shape[0]:], 0.0, atol=1e-12)


def test_dia_to_dense():
    a = _poisson_2d_scipy(5)
    dia = DIAMatrix.from_scipy(a, dtype=jnp.float64)
    np.testing.assert_allclose(np.asarray(dia.to_dense()), a.toarray(),
                               rtol=1e-12)


def test_poisson_dia_matches_scipy_2d():
    nx = 16
    built = poisson_dia((nx, nx), dtype=jnp.float64)
    ref = _poisson_2d_scipy(nx)
    np.testing.assert_allclose(np.asarray(built.to_dense()),
                               ref.toarray(), rtol=1e-12)


def test_poisson_dia_3d_structure():
    shape = (6, 5, 4)
    built = poisson_dia(shape, dtype=jnp.float64)
    dense = np.asarray(built.to_dense())
    np.testing.assert_allclose(dense, dense.T)
    assert (np.diag(dense) == 6.0).all()
    eig = np.linalg.eigvalsh(dense)
    assert eig.min() > 0


def test_dia_to_scipy_symmetric_and_matches_matvec():
    """to_scipy must reproduce the operator exactly (symmetric for
    Poisson) — sp.diags on the raw vals misaligns off-diagonals."""
    a = poisson_dia((5, 6, 7), dtype=jnp.float64)
    m = a.to_scipy()
    asym = abs(m - m.T)
    assert asym.nnz == 0 or asym.max() < 1e-14
    rng = np.random.default_rng(0)
    x = rng.standard_normal(a.n)
    xp = np.zeros(a.n_pad)
    xp[: a.n] = x
    y_dia = np.asarray(a.matvec(jnp.asarray(xp)))[: a.n]
    np.testing.assert_allclose(m @ x, y_dia, rtol=1e-12, atol=1e-12)
