"""BSR container tests."""

import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from deeppreconditioning_tpu.data.fvm import generate_sludge_case
from deeppreconditioning_tpu.sparse.bsr import BSRMatrix


def _fvm_matrix():
    case = generate_sludge_case(np.random.default_rng(0), mesh_cells=1)
    return case.matrix.tocsr()


def test_bsr_matvec_matches_scipy():
    a = _fvm_matrix()
    n = a.shape[0]
    bsr = BSRMatrix.from_scipy(a, block_size=32, dtype=jnp.float64)
    rng = np.random.default_rng(1)
    x = np.zeros(bsr.n_pad)
    x[:n] = rng.standard_normal(n)
    y = np.asarray(bsr.matvec(jnp.asarray(x)))
    np.testing.assert_allclose(y[:n], a @ x[:n], rtol=1e-10,
                               atol=1e-12)


def test_bsr_random_pattern():
    rng = np.random.default_rng(4)
    b = sp.random(100, 100, density=0.05, random_state=rng)
    a = (b @ b.T + 10 * sp.eye(100)).tocsr()
    bsr = BSRMatrix.from_scipy(a, block_size=16, dtype=jnp.float64)
    x = rng.standard_normal(bsr.n_pad)
    y = np.asarray(bsr.matvec(jnp.asarray(x)))
    np.testing.assert_allclose(y[:100], a @ x[:100], rtol=1e-10)
