"""Determinism: seeded runs reproduce bit-identical results.

The reference pins seeds and forces deterministic kernels
(train.py:24-37: seed 69, use_deterministic_algorithms, cudnn flags).
XLA is deterministic by default on the CPU; these tests pin the
framework-level contract: same seed -> same init, same data, same loss.
"""

import jax
import numpy as np
import optax

from deeppreconditioning_tpu.data.datasets import RandomSPDDataSet
from deeppreconditioning_tpu.data.fvm import generate_sludge_case
from deeppreconditioning_tpu.models import PreconditionerNet, precond_net_specs
from deeppreconditioning_tpu.train.trainer import TrainState, train_step

CHANNELS = (1, 8, 16, 8, 1)
SPECS = precond_net_specs(CHANNELS)


def _run_two_steps(seed):
    ds = RandomSPDDataSet("train", dof=12, batch_size=2, specs=SPECS,
                          sparsity=0.9, length=4, seed=seed,
                          shuffle=False)
    model = PreconditionerNet(channels=CHANNELS)
    tx = optax.adam(1e-3)
    b0 = ds[0]
    sp = [jax.tree.map(lambda x: x[0], p) for p in b0.plans]
    params = model.init(jax.random.PRNGKey(seed), b0.features[0], sp)
    state = TrainState(params, tx.init(params), 0)
    losses = []
    for _ in range(2):
        state, loss = train_step(model, tx, state, b0)
        losses.append(float(loss))
    return losses


def test_training_deterministic():
    assert _run_two_steps(7) == _run_two_steps(7)


def test_training_seed_sensitivity():
    assert _run_two_steps(7) != _run_two_steps(8)


def test_generator_deterministic():
    c1 = generate_sludge_case(np.random.default_rng(42), mesh_cells=1)
    c2 = generate_sludge_case(np.random.default_rng(42), mesh_cells=1)
    assert (c1.matrix != c2.matrix).nnz == 0
    np.testing.assert_array_equal(c1.rhs, c2.rhs)
