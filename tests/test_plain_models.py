"""Plain-JAX models against outputs recorded from their former flax.linen
versions.

``tests/fixtures/model_parity.npz`` holds, for PreconditionerNet,
PreconditionerSparseUNet and NeuralFSAI: a perturbed parameter tree
(the flax layout, keyed by path), the sample input and the output the
flax module computed on it.  Each test rebuilds the plans the fixture
was made with, applies the plain model to the recorded parameters, and
compares.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

FIXTURE = Path(__file__).parent / "fixtures" / "model_parity.npz"


def _params(prefix: str) -> dict:
    """Nested {"params": {...}} tree from the fixture's path keys."""
    tree: dict = {}
    with np.load(FIXTURE) as data:
        for key in data.files:
            if not key.startswith(prefix + "params/"):
                continue
            *parents, leaf = key[len(prefix):].split("/")
            node = tree
            for name in parents:
                node = node.setdefault(name, {})
            node[leaf] = jnp.asarray(data[key])
    return tree


def _recorded(key: str) -> np.ndarray:
    with np.load(FIXTURE) as data:
        return data[key]


def _sample(plans):
    return [jax.tree.map(lambda x: x[0], p) for p in plans]


def test_precond_net_matches_flax_record(monkeypatch):
    import test_model

    from deeppreconditioning_tpu.models import PreconditionerNet

    channels = (1, 4, 8, 8, 8, 4, 1)
    monkeypatch.setattr(test_model, "CHANNELS", channels)
    _, plans = test_model._identity_batch()
    model = PreconditionerNet(channels=channels)
    out = model.apply(_params("precond_net/"),
                      jnp.asarray(_recorded("precond_net/features")),
                      _sample(plans))
    np.testing.assert_allclose(np.asarray(out),
                               _recorded("precond_net/out"),
                               rtol=1e-6, atol=1e-7)


def test_sparse_unet_matches_flax_record():
    import test_sparse_unet

    from deeppreconditioning_tpu.models import PreconditionerSparseUNet

    _, plans = test_sparse_unet._unet_batch()
    model = PreconditionerSparseUNet(channels=(1, 4, 8, 8, 8, 4, 1))
    out = model.apply(_params("unet/"),
                      jnp.asarray(_recorded("unet/features")),
                      _sample(plans))
    np.testing.assert_allclose(np.asarray(out), _recorded("unet/out"),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("field", ["c_vals", "q_coeffs"])
def test_neural_fsai_matches_flax_record(field):
    import test_neural_fsai

    _, _, model, params, _, plans, operands = test_neural_fsai._setup()
    recorded = _params("neural_fsai/")
    # same tree structure as the model's own init
    assert (jax.tree.structure(params)
            == jax.tree.structure(recorded))
    sample_plan = jax.tree.map(lambda x: x[0], plans)
    out = model.apply(recorded, sample_plan, operands[0])
    np.testing.assert_allclose(np.asarray(getattr(out, field)),
                               _recorded(f"neural_fsai/{field}"),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("model_name", [
    "PreconditionerNet", "PreconditionerSparseUNet",
])
def test_conv_model_init_tree_matches_flax_layout(model_name):
    """init builds the parameter tree the flax modules built: same
    names, shapes and dtypes as the recorded (flax-made) tree."""
    from deeppreconditioning_tpu import models

    prefix = {"PreconditionerNet": "precond_net/",
              "PreconditionerSparseUNet": "unet/"}[model_name]
    model = getattr(models, model_name)(channels=(1, 4, 8, 8, 8, 4, 1))
    mine = model.init(jax.random.PRNGKey(0))
    rec = _params(prefix)
    assert jax.tree.structure(mine) == jax.tree.structure(rec)
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(rec)):
        assert a.shape == b.shape and a.dtype == b.dtype


@pytest.mark.parametrize("model_name", [
    "PreconditionerNet", "PreconditionerSparseUNet", "NeuralFSAI",
])
def test_init_reproduces_recorded_weights(model_name):
    """A seed gives bit-identical initial weights to the recorded
    (flax-made) initialization, so training from a seed follows the
    same trajectory it always did."""
    import test_neural_fsai

    from deeppreconditioning_tpu import models

    if model_name == "NeuralFSAI":
        _, _, _, mine, _, _, _ = test_neural_fsai._setup()
        prefix = "neural_fsai/init/"
    else:
        model = getattr(models, model_name)(channels=(1, 4, 8, 8, 8, 4, 1))
        seed, prefix = {
            "PreconditionerNet": (3, "precond_net/init/"),
            "PreconditionerSparseUNet": (4, "unet/init/"),
        }[model_name]
        mine = model.init(jax.random.PRNGKey(seed))
    rec = _params(prefix)
    assert jax.tree.structure(mine) == jax.tree.structure(rec)
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(rec)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
