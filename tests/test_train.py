"""Training-loop integration: loss decreases, checkpoints resume."""

import jax
import numpy as np
import optax

from deeppreconditioning_tpu.data.datasets import RandomSPDDataSet
from deeppreconditioning_tpu.models import PreconditionerNet, precond_net_specs
from deeppreconditioning_tpu.train.trainer import (
    EarlyStopping,
    TrainState,
    resume_state,
    save_checkpoint,
    train_step,
    validate,
)

CHANNELS = (1, 8, 16, 8, 1)  # small but same architecture family
SPECS = precond_net_specs(CHANNELS)


def _tiny_dataset(stage):
    return RandomSPDDataSet(stage, dof=16, batch_size=2, specs=SPECS,
                            sparsity=0.9, length=10, seed=3,
                            shuffle=False)


def test_training_reduces_loss_and_iterations(tmp_path):
    train_set = _tiny_dataset("train")
    val_set = _tiny_dataset("test")
    model = PreconditionerNet(channels=CHANNELS)
    tx = optax.adam(1e-2)

    batch0 = train_set[0]
    sample_plans = [jax.tree.map(lambda x: x[0], p) for p in batch0.plans]
    params = model.init(jax.random.PRNGKey(69), batch0.features[0],
                        sample_plans)
    state = TrainState(params, tx.init(params), 0)

    loss0, iters0, _ = validate(model, state.params, val_set)
    losses = []
    for _ in range(30):
        for i in range(len(train_set)):
            state, loss = train_step(model, tx, state, train_set[i])
        losses.append(float(loss))
    loss1, iters1, _ = validate(model, state.params, val_set)

    assert loss1 < loss0, f"val loss should drop: {loss0} -> {loss1}"
    assert losses[-1] < losses[0]
    assert iters1 <= iters0, (
        f"CG iterations should not increase: {iters0} -> {iters1}"
    )


def test_checkpoint_roundtrip(tmp_path):
    train_set = _tiny_dataset("train")
    model = PreconditionerNet(channels=CHANNELS)
    tx = optax.adam(1e-3)
    batch0 = train_set[0]
    sample_plans = [jax.tree.map(lambda x: x[0], p) for p in batch0.plans]
    params = model.init(jax.random.PRNGKey(0), batch0.features[0],
                        sample_plans)
    state = TrainState(params, tx.init(params), 0)
    state, _ = train_step(model, tx, state, batch0)

    path = tmp_path / "ckpt.npz"
    save_checkpoint(path, model, state)
    restored = resume_state(path, tx)

    for a, b in zip(jax.tree.leaves(state.params),
                    jax.tree.leaves(restored.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b))
    # resumed state continues training identically
    s1, l1 = train_step(model, tx, state, batch0)
    s2, l2 = train_step(model, tx, restored, batch0)
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-6)


def test_early_stopping():
    stopper = EarlyStopping(patience=3)
    assert not stopper(1.0)
    assert not stopper(0.5)
    assert not stopper(0.6)
    assert not stopper(0.7)
    assert stopper(0.8)  # third non-improvement
    stopper2 = EarlyStopping(patience=2)
    assert not stopper2(1.0)
    assert not stopper2(1.1)
    assert stopper2(1.2)
