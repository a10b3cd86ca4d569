"""Structured-grid FSAI (ops/structured_fsai.py) vs generic oracles."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from deeppreconditioning_tpu.data.poisson import poisson_coeff_dia
from deeppreconditioning_tpu.ops.structured_fsai import (
    build_structured_plan,
    dia_sorted_by_offset,
    jacobi_scale_dia,
    make_structured_poly_apply,
    offset_lower_matvec,
    offset_upper_matvec,
    slot_valid,
    structured_fsai_columns,
    structured_refine,
    structured_setup,
)
from deeppreconditioning_tpu.sparse.dia import poisson_dia


def _bands_to_dense(bands, offsets, n):
    c = np.zeros((n, n))
    b = np.asarray(bands)
    for k, off in enumerate(offsets):
        rows = np.arange(n - off)
        c[rows + off, rows] = b[k, rows]
    return c


def test_poisson_coeff_dia_spd_and_symmetric():
    rng = np.random.default_rng(0)
    a = poisson_coeff_dia((5, 6, 4), rng=rng, dtype=jnp.float64)
    m = a.to_scipy().toarray()
    np.testing.assert_allclose(m, m.T, atol=1e-12)
    w = np.linalg.eigvalsh(m)
    assert w.min() > 0


def test_structured_plan_power2_width():
    plan = build_structured_plan((6, 5, 4), power=2)
    assert plan.width == 13
    assert plan.offsets[0] == 0
    plan2 = build_structured_plan((8, 8), power=2)
    assert plan2.width == 7  # 2-D: 0,1,2,nx-1,nx,nx+1,2nx


def test_structured_columns_match_generic_fsai():
    """Offset-band local solves equal ops/fsai's scipy reference on the
    equivalent graph-power pattern (interior AND boundary columns)."""
    from deeppreconditioning_tpu.ops.fsai import (
        fsai_factor_scipy,
        tril_power_pattern,
    )

    shape = (5, 4, 3)
    a = poisson_coeff_dia(shape, rng=np.random.default_rng(1),
                          dtype=jnp.float64)
    a_scaled, _ = jacobi_scale_dia(a)
    plan = build_structured_plan(shape, power=2)
    bands = structured_fsai_columns(a_scaled, plan)
    n = a.n
    got = _bands_to_dense(bands, plan.offsets, n)

    a_sc = a_scaled.to_scipy()
    coo = sp.tril(a_sc).tocoo()
    pr, pc = tril_power_pattern(
        coo.row.astype(np.int32), coo.col.astype(np.int32), n, power=2
    )
    expect = fsai_factor_scipy(a_sc, pr, pc).toarray()
    np.testing.assert_allclose(got, expect, rtol=1e-8, atol=1e-10)


def test_structured_refine_matches_flax_module():
    """structured_refine reproduces NeuralFSAI.apply's c_vals/q on the
    same pattern with randomly initialized (nonzero) parameters.

    Parity is exact on INTERIOR columns (every pattern slot live);
    boundary columns use a different slot layout by design (generic
    plans pack live slots to the front; the structured layout keys
    slots by fixed offset — see structured_refine's docstring)."""
    from deeppreconditioning_tpu.models import NeuralFSAI
    from deeppreconditioning_tpu.ops.fsai import (
        build_fsai_plan,
        tril_power_pattern,
    )
    from deeppreconditioning_tpu.ops.structured_fsai import (
        dia_sorted_by_offset,
        structured_a_col,
    )

    shape = (5, 4, 3)
    n = int(np.prod(shape))
    a = poisson_coeff_dia(shape, rng=np.random.default_rng(2),
                          dtype=jnp.float64)
    a_scaled, _ = jacobi_scale_dia(dia_sorted_by_offset(a))
    plan = build_structured_plan(shape, power=2)
    w = plan.width

    # generic plan on the same pattern, padded to n_pad
    n_pad = a.n_pad
    a_sc = a_scaled.to_scipy()
    tril = sp.tril(a_sc).tocoo()
    order = np.argsort(tril.row.astype(np.int64) * n_pad + tril.col)
    l0_rows = np.concatenate([tril.row[order].astype(np.int32),
                              np.arange(n, n_pad, dtype=np.int32)])
    l0_cols = np.concatenate([tril.col[order].astype(np.int32),
                              np.arange(n, n_pad, dtype=np.int32)])
    l0_vals = np.concatenate([tril.data[order], np.ones(n_pad - n)])
    pr, pc = tril_power_pattern(l0_rows, l0_cols, n_pad, power=2)
    gplan = build_fsai_plan(l0_rows, l0_cols, pr, pc, n_pad, width=w)

    model = NeuralFSAI(width=w, hidden=16, poly_degree=1)
    variables = model.init(
        jax.random.PRNGKey(0), gplan, jnp.asarray(l0_vals)
    )
    # randomize the zero-init heads so the test is non-trivial
    leaves, tree = jax.tree.flatten(variables)
    rng = np.random.default_rng(3)
    leaves = [jnp.asarray(0.2 * rng.standard_normal(leaf.shape),
                          leaf.dtype) for leaf in leaves]
    variables = jax.tree.unflatten(tree, leaves)

    out = model.apply(variables, gplan, jnp.asarray(l0_vals))
    expect = np.zeros((n, n))
    orows = np.asarray(gplan.out_rows)
    cv = np.asarray(out.c_vals)
    for j in range(n):
        for k in range(w):
            r = orows[j, k]
            if r < n:
                expect[r, j] = cv[j, k]

    base = structured_fsai_columns(a_scaled, plan)
    valid = slot_valid(plan, n_pad).astype(base.dtype)
    a_col = structured_a_col(a_scaled, plan)
    refined, q = structured_refine(variables, base, a_col, valid)
    got = _bands_to_dense(refined, plan.offsets, n)
    interior = np.asarray(valid[:n]).all(axis=1)
    assert interior.sum() >= 3  # the test grid must have interior cols
    np.testing.assert_allclose(
        got[:, interior], expect[:, interior], rtol=1e-6, atol=1e-9
    )
    np.testing.assert_allclose(
        np.asarray(q), np.asarray(out.q_coeffs), rtol=1e-7
    )


def test_offset_matvecs_match_dense():
    shape = (6, 5)
    plan = build_structured_plan(shape, power=2)
    n = int(np.prod(shape))
    a = poisson_dia(shape, dtype=jnp.float64)
    a_scaled, _ = jacobi_scale_dia(a)
    bands = structured_fsai_columns(a_scaled, plan)
    c = _bands_to_dense(bands, plan.offsets, a.n_pad)
    rng = np.random.default_rng(4)
    r = rng.standard_normal(a.n_pad)
    r[n:] = 0.0
    np.testing.assert_allclose(
        np.asarray(offset_upper_matvec(bands, jnp.asarray(r),
                                       plan.offsets)),
        c.T @ r, rtol=1e-8, atol=1e-10,
    )
    np.testing.assert_allclose(
        np.asarray(offset_lower_matvec(bands, jnp.asarray(r),
                                       plan.offsets)),
        c @ r, rtol=1e-8, atol=1e-10,
    )


def test_structured_pcg_classical_and_learned():
    """End-to-end: structured FSAI (classical and refined) inside PCG
    beats vanilla CG on a variable-coefficient Poisson system."""
    from deeppreconditioning_tpu.solvers.cg import (
        conjugate_gradient,
        preconditioned_conjugate_gradient,
    )

    shape = (8, 8, 8)
    a = poisson_coeff_dia(shape, rng=np.random.default_rng(5),
                          sigma=1.0, dtype=jnp.float64)
    n = a.n
    rng = np.random.default_rng(6)
    x_star = np.zeros(a.n_pad)
    x_star[:n] = rng.standard_normal(n)
    b = np.asarray(a.matvec(jnp.asarray(x_star)))

    def matvec(a_data, x):
        return a_data.matvec(x)

    plain = conjugate_gradient(matvec, a, jnp.asarray(b))
    plan = build_structured_plan(shape, power=2)
    bands, q = structured_setup(a, plan)
    apply_fn = make_structured_poly_apply(plan.offsets,
                                          len(np.asarray(q)) - 1)
    pre = preconditioned_conjugate_gradient(
        matvec, a, jnp.asarray(b), apply_fn, (bands, q, a),
    )
    assert float(pre.residual) < 1e-8
    assert int(pre.iterations) < int(plain.iterations) * 0.7, (
        int(pre.iterations), int(plain.iterations)
    )
    x = np.asarray(pre.x)
    err = np.linalg.norm(x[:n] - x_star[:n]) / np.linalg.norm(x_star[:n])
    assert err < 1e-3


# -- polynomial spectral safeguard (VERDICT r4 next #2) ---------------------

def _ckpt():
    from deeppreconditioning_tpu.train.trainer import load_checkpoint
    p = (Path(__file__).resolve().parent.parent / "assets"
         / "checkpoints_structured" / "best.npz")
    if not p.exists():
        import pytest
        pytest.skip("structured checkpoint not present")
    return load_checkpoint(p)


def test_poly_safeguard_clamps_root_inside_spectrum():
    """A q with a root inside B's spectrum is replaced by q = I; a safe
    q passes through unchanged."""
    from deeppreconditioning_tpu.ops.structured_fsai import (
        jacobi_scale_dia,
        poly_safeguard,
        structured_fsai_columns,
    )

    shape = (8, 8, 8)
    a = poisson_coeff_dia(shape, rng=np.random.default_rng(1),
                          sigma=1.0, dtype=jnp.float64)
    a = dia_sorted_by_offset(a)
    plan = build_structured_plan(shape, power=2)
    a_scaled, _ = jacobi_scale_dia(a)
    bands = structured_fsai_columns(a_scaled, plan)
    # FSAI pushes B toward I: spectrum well inside [0, ~2] — a root at
    # t = 0.5 sits inside it, a root at t = 50 far outside
    bad = jnp.asarray([1.0, -2.0])       # q(t) = 1 - 2 t, root 0.5
    good = jnp.asarray([1.0, -0.02])     # root 50
    q_bad, safe_bad, lam = poly_safeguard(
        bands, bad, a_scaled, plan.offsets
    )
    q_good, safe_good, _ = poly_safeguard(
        bands, good, a_scaled, plan.offsets
    )
    assert not bool(safe_bad)
    np.testing.assert_allclose(np.asarray(q_bad), [1.0, 0.0])
    assert bool(safe_good)
    np.testing.assert_allclose(np.asarray(q_good), np.asarray(good))
    assert 0.1 < float(lam) < 10.0  # plausible lambda_max of B ~ I


def test_safeguard_sigma_sweep_no_breakdowns():
    """sigma in {0..3} with the trained checkpoint: the guarded setup
    always converges; the fallback (q = I) engages at sigma = 3 and the
    learned q survives at sigma <= 2 (the deployment family of the
    scaling benchmark)."""
    from deeppreconditioning_tpu.solvers.cg import (
        preconditioned_conjugate_gradient,
    )
    from deeppreconditioning_tpu.sparse.dia import poisson_dia

    payload = _ckpt()
    params = payload["params"]
    degree = int(payload["poly_degree"])
    shape = (16, 16, 16)
    plan = build_structured_plan(shape, power=int(payload["power"]))
    apply_fn = make_structured_poly_apply(plan.offsets, degree)
    ident = np.zeros(degree + 1)
    ident[0] = 1.0

    for sigma in (0.0, 1.0, 2.0, 3.0):
        if sigma == 0.0:
            a = poisson_dia(shape, dtype=jnp.float32)
        else:
            a = poisson_coeff_dia(
                shape, rng=np.random.default_rng(1), sigma=sigma,
                dtype=jnp.float32,
            )
        a = dia_sorted_by_offset(a)
        rng = np.random.default_rng(2)
        x_star = np.zeros(a.n_pad, np.float32)
        x_star[:a.n] = rng.standard_normal(a.n)
        b = a.matvec(jnp.asarray(x_star))
        bands, q = structured_setup(a, plan, params)
        res = preconditioned_conjugate_gradient(
            lambda ad, x: ad.matvec(x), a, b,
            apply_m=apply_fn, m_data=(bands, q, a), rtol=1e-8,
        )
        assert float(res.residual) < 1e-8, sigma
        fell_back = np.allclose(np.asarray(q), ident)
        if sigma <= 2.0:
            assert not fell_back, (sigma, np.asarray(q))
        if sigma == 3.0:
            assert fell_back, (sigma, np.asarray(q))


def test_dia_apply_matches_offset_apply_and_sequence_solver():
    """bands_to_dia + make_structured_poly_apply_dia reproduce the
    offset-form apply exactly, and pcg_sequence_fixed_trips matches
    k independent flat solves."""
    from deeppreconditioning_tpu.data.poisson import (
        poisson_rhs_sequence,
    )
    from deeppreconditioning_tpu.ops.structured_fsai import (
        bands_to_dia,
        make_structured_poly_apply_dia,
    )
    from deeppreconditioning_tpu.solvers.cg import (
        pcg_fixed_trips,
        pcg_sequence_fixed_trips,
    )

    shape = (6, 5, 4)
    a = dia_sorted_by_offset(poisson_coeff_dia(
        shape, rng=np.random.default_rng(3), sigma=1.0,
        dtype=jnp.float64,
    ))
    plan = build_structured_plan(shape, power=2)
    bands, q = structured_setup(a, plan)
    q2 = jnp.asarray([0.9, -0.1])  # exercise degree 1
    r = jnp.asarray(np.random.default_rng(4).standard_normal(a.n_pad))

    old = make_structured_poly_apply(plan.offsets, 1)(
        (bands, q2, a), r
    )
    c_up, c_low = bands_to_dia(bands, plan.offsets, a.n)
    new = make_structured_poly_apply_dia(1)((c_up, c_low, q2, a), r)
    np.testing.assert_allclose(
        np.asarray(new), np.asarray(old), rtol=1e-12, atol=1e-14
    )

    # sequence solver == k independent fixed-trip solves
    b_seq, x_seq = poisson_rhs_sequence(
        a, 3, np.random.default_rng(5)
    )
    apply_fn = make_structured_poly_apply_dia(0)
    m_data = (c_up, c_low, jnp.ones((1,), jnp.float64), a)
    xs, its, ress = pcg_sequence_fixed_trips(
        lambda ad, x: ad.matvec(x), a, jnp.asarray(b_seq),
        apply_m=apply_fn, m_data=m_data, trips=40,
    )
    for t in range(3):
        one = pcg_fixed_trips(
            lambda ad, x: ad.matvec(x), a, jnp.asarray(b_seq[t]),
            apply_m=apply_fn, m_data=m_data, trips=40,
        )
        assert int(its[t]) == int(one.iterations)
        np.testing.assert_allclose(
            np.asarray(xs[t]), np.asarray(one.x), rtol=1e-12
        )
        assert float(ress[t]) < 1e-8
        n = a.n
        err = (np.linalg.norm(np.asarray(xs[t])[:n] - x_seq[t][:n])
               / np.linalg.norm(x_seq[t][:n]))
        assert err < 1e-4
