"""Dataset tests: batch shapes, padding semantics, reference parity."""

import numpy as np
import pytest

from deeppreconditioning_tpu.data.datasets import (
    RandomSPDDataSet,
    SludgePatternDataSet,
)
from deeppreconditioning_tpu.data.fvm import generate_sludge_case, save_case
from deeppreconditioning_tpu.models import precond_net_specs

CHANNELS = (1, 8, 8, 8, 8, 8, 1)
SPECS = precond_net_specs(CHANNELS)


@pytest.fixture(scope="module")
def sludge_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(0)
    for i in range(10):
        case = generate_sludge_case(rng, mesh_cells=1)
        save_case(case, root / "sludge_patterns" / f"case_{i:04d}")
    return root


def test_sludge_dataset_batches(sludge_root):
    ds = SludgePatternDataSet("train", batch_size=2, specs=SPECS,
                              shuffle=False, root=sludge_root)
    assert len(ds) == 4  # 8 train folders (80%), batch 2
    batch = ds[0]
    bsz, nnz0, c = batch.features.shape
    assert bsz == 2 and c == 1
    assert batch.solutions.shape == batch.right_hand_sides.shape
    assert batch.solutions.shape[1] % 128 == 0  # dof_pad tiles cleanly
    assert len(batch.plans) == len(SPECS)
    # identical shapes across batches -> single compiled executable
    b2 = ds[1]
    assert b2.features.shape == batch.features.shape
    for p1, p2 in zip(batch.plans, b2.plans):
        assert p1.gather.shape == p2.gather.shape


def test_sludge_batch_system_matches_case(sludge_root):
    ds = SludgePatternDataSet("train", batch_size=1, specs=SPECS,
                              shuffle=False, root=sludge_root)
    batch = ds[0]
    n0 = batch.original_sizes[0]
    import scipy.sparse as sp

    with np.load(sludge_root / "sludge_patterns" / "case_0000"
                 / "matrix.npz") as z:
        a = sp.coo_matrix((z["data"], (z["row"], z["col"])),
                          shape=tuple(z["shape"]))
    dense_tril = np.asarray(batch.systems.to_dense())[0]
    d = np.asarray(batch.scales[0], np.float64)
    # undo the symmetric Jacobi scaling: A = D^1/2 A~ D^1/2
    d_sqrt = np.sqrt(d[:n0])
    full_tril = np.tril(a.toarray())
    np.testing.assert_allclose(
        dense_tril[:n0, :n0] * np.outer(d_sqrt, d_sqrt), full_tril,
        rtol=1e-4, atol=1e-10,
    )
    # identity padding beyond n0 (data_set.py:94-97 semantics)
    np.testing.assert_allclose(np.diag(dense_tril)[n0:], 1.0)
    # the scaled system has unit diagonal
    np.testing.assert_allclose(np.diag(dense_tril)[:n0], 1.0, rtol=1e-5)
    # scaled ground truth still solves the scaled system
    a_tilde = dense_tril + np.tril(dense_tril, -1).T
    np.testing.assert_allclose(
        a_tilde[:n0, :n0] @ np.asarray(batch.solutions[0])[:n0],
        np.asarray(batch.right_hand_sides[0])[:n0],
        rtol=1e-4, atol=1e-3,
    )


def test_split_disjoint_and_8020(sludge_root):
    tr = SludgePatternDataSet("train", batch_size=1, specs=SPECS,
                              shuffle=False, root=sludge_root)
    te = SludgePatternDataSet("test", batch_size=1, specs=SPECS,
                              shuffle=False, root=sludge_root)
    assert len(tr.folders) == 8 and len(te.folders) == 2
    assert not (set(tr.folders) & set(te.folders))


def test_random_spd_dataset():
    ds = RandomSPDDataSet("train", dof=24, batch_size=2, specs=SPECS,
                          sparsity=0.95, length=10, seed=1)
    batch = ds[0]
    a_tril = np.asarray(batch.systems.to_dense())
    a_full = a_tril + np.tril(a_tril, -1).transpose(0, 2, 1)
    for b in range(2):
        n = batch.original_sizes[b]
        assert n == 24
        eig = np.linalg.eigvalsh(a_full[b])
        assert eig.min() > 0, "random SPD matrices must be SPD"
        # b = A @ x contract (data_set.py:289-290), scaled consistently
        x = np.asarray(batch.solutions[b])
        rhs = np.asarray(batch.right_hand_sides[b])
        np.testing.assert_allclose(a_full[b] @ x, rhs, rtol=1e-4,
                                   atol=1e-5)
