"""Every float32 contraction in a PCG step states its precision.

On the GPU a float32 ``dot_general`` with no precision may run in TF32
(about three decimal digits), which would stall the 1e-8 stopping rule.
These tests trace the jacobi, fsai and learned PCG solves of both
benchmark protocols (per case and batched) and check every float32
``dot_general`` in the jaxpr asks for HIGHEST.  bf16 contractions are
bf16 on purpose and are not checked.
"""

import jax
import jax.extend.core as jex_core
import jax.numpy as jnp
import numpy as np
import pytest

from deeppreconditioning_tpu.bench.suite import (
    BenchmarkSuite,
    _scaled_dense_matvec,
)
from deeppreconditioning_tpu.data.datasets import RandomSPDDataSet
from deeppreconditioning_tpu.models import (
    FSAIPlanProvider,
    NeuralFSAI,
    precond_net_specs,
)
from deeppreconditioning_tpu.solvers.cg import (
    batched_pcg_fixed_trips,
    ell_matvec,
    preconditioned_conjugate_gradient,
)
from deeppreconditioning_tpu.sparse import ELLMatrix

TECHNIQUES = ("jacobi", "fsai", "learned")


def _subjaxprs(value):
    if isinstance(value, jex_core.ClosedJaxpr):
        yield value.jaxpr
    elif isinstance(value, jex_core.Jaxpr):
        yield value
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _subjaxprs(v)


def _dot_generals(jaxpr):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn
        for value in eqn.params.values():
            for sub in _subjaxprs(value):
                yield from _dot_generals(sub)


def _assert_highest(closed):
    dots = list(_dot_generals(closed.jaxpr))
    f32 = [e for e in dots
           if all(v.aval.dtype == jnp.float32 for v in e.invars)]
    assert f32, "no float32 contraction traced"
    for eqn in f32:
        prec = eqn.params["precision"]
        assert prec is not None and all(
            p == jax.lax.Precision.HIGHEST for p in prec
        ), (eqn, prec)


@pytest.fixture(scope="module")
def suite(tmp_path_factory):
    specs = precond_net_specs((1, 1, 1))
    ds = RandomSPDDataSet(
        "train", dof=40, batch_size=1, specs=specs, sparsity=0.85,
        length=2, seed=3, shuffle=False,
    )
    width = 40
    provider = FSAIPlanProvider(ds, power=2, width=width)
    model = NeuralFSAI(width=width, hidden=8, poly_degree=1)
    batch = ds[0]
    plans = provider(0, batch)
    operand = batch.systems.to_dense()[0]
    params = model.init(jax.random.PRNGKey(0),
                        jax.tree.map(lambda x: x[0], plans),
                        operand.astype(jnp.float32))
    return BenchmarkSuite(
        ds, model, params, techniques=TECHNIQUES, timing_reps=1,
        kappa_cases=0, fsai_power=2, learned_power=2,
        results_directory=tmp_path_factory.mktemp("precision"),
    )


@pytest.mark.parametrize("name", TECHNIQUES)
def test_per_case_pcg_contractions_are_highest(suite, name):
    suite._case_index = 0
    a_sp, rhs, n0 = suite._reconstruct(0)
    batch = suite.data_set[0]
    ell = ELLMatrix.from_scipy(a_sp, n_pad=batch.solutions.shape[1],
                               dtype=jnp.float32)
    b = np.zeros(ell.n_pad, np.float32)
    b[:n0] = rhs
    apply_m, m_data, _, _ = getattr(suite, f"_setup_{name}")(
        a_sp, batch, ell, False)
    closed = jax.make_jaxpr(
        lambda bb: preconditioned_conjugate_gradient(
            ell_matvec, ell, bb, apply_m, m_data)
    )(jnp.asarray(b))
    _assert_highest(closed)


@pytest.mark.parametrize("name", TECHNIQUES)
def test_batched_pcg_contractions_are_highest(suite, name):
    common = suite._batched_common()
    apply_fn, m_data, _ = suite._batched_setup(name, 1, 2, m_dtype=None)
    a_data = (common["a_tilde"], common["d_sqrt"])
    closed = jax.make_jaxpr(
        lambda bb: batched_pcg_fixed_trips(
            _scaled_dense_matvec, a_data, bb, apply_fn, m_data, trips=2)
    )(common["b"])
    _assert_highest(closed)
