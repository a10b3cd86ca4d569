"""FSAI: device batched solves == scipy reference; PCG quality."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from deeppreconditioning_tpu.ops.fsai import (
    build_fsai_plan,
    fsai_dense_preconditioner,
    fsai_factor_scipy,
    fsai_values,
    tril_power_pattern,
)


def _poisson2d(nx):
    n = nx * nx
    main = 4.0 * np.ones(n)
    off = -1.0 * np.ones(n - 1)
    off[np.arange(1, n) % nx == 0] = 0.0
    offy = -1.0 * np.ones(n - nx)
    a = sp.diags(
        [main, off, off, offy, offy], [0, -1, 1, -nx, nx]
    ).tocsr()
    return a


def _tril_sites(a):
    coo = sp.tril(a).tocoo()
    order = np.argsort(
        coo.row.astype(np.int64) * a.shape[0] + coo.col, kind="stable"
    )
    return (coo.row[order].astype(np.int32),
            coo.col[order].astype(np.int32),
            coo.data[order])


def test_fsai_values_match_scipy():
    a = _poisson2d(8)
    n = a.shape[0]
    rows, cols, vals = _tril_sites(a)
    pr, pc = tril_power_pattern(rows, cols, n, power=3)
    plan = build_fsai_plan(rows, cols, pr, pc, n)
    c_vals = np.asarray(fsai_values(plan, jnp.asarray(vals)))
    c_ref = fsai_factor_scipy(a, pr, pc).toarray()
    s_mat = np.asarray(plan.out_rows)
    for j in range(n):
        for k in range(plan.width):
            i = s_mat[j, k]
            if i < n:
                assert abs(c_vals[j, k] - c_ref[i, j]) < 1e-8, (i, j)


def test_fsai_preconditioner_spd_and_effective():
    a = _poisson2d(12)
    n = a.shape[0]
    rows, cols, vals = _tril_sites(a)
    pr, pc = tril_power_pattern(rows, cols, n, power=2)
    plan = build_fsai_plan(rows, cols, pr, pc, n)
    m = np.asarray(
        fsai_dense_preconditioner(plan, jnp.asarray(vals),
                                  dtype=jnp.float64)
    )
    np.testing.assert_allclose(m, m.T, atol=1e-12)
    eig = np.linalg.eigvalsh(m)
    assert eig.min() > 0
    ad = a.toarray()
    kappa_pre = np.linalg.cond(ad)
    kappa_post = np.linalg.cond(m @ ad)
    assert kappa_post < 0.2 * kappa_pre


def test_fsai_beats_jacobi_iterations():
    a = _poisson2d(16)
    n = a.shape[0]
    rows, cols, vals = _tril_sites(a)
    pr, pc = tril_power_pattern(rows, cols, n, power=3)
    plan = build_fsai_plan(rows, cols, pr, pc, n)
    m = np.asarray(
        fsai_dense_preconditioner(plan, jnp.asarray(vals),
                                  dtype=jnp.float64)
    )
    rng = np.random.default_rng(0)
    b = rng.standard_normal(n)

    def iters(apply_m):
        x = np.zeros(n)
        r = b.copy()
        z = apply_m(r)
        p = z.copy()
        bb = b @ b
        for it in range(1024):
            if (r @ r) / bb < 1e-8:
                return it
            ap = a @ p
            rz = r @ z
            alpha = rz / (ap @ p)
            x += alpha * p
            r -= alpha * ap
            z = apply_m(r)
            beta = (r @ z) / rz
            p = z + beta * p
        return 1024

    it_jacobi = iters(lambda r: r / a.diagonal())
    it_fsai = iters(lambda r: m @ r)
    assert it_fsai < 0.5 * it_jacobi, (it_fsai, it_jacobi)


def test_range_path_matches_generic():
    """Range-blocked fast path == generic element-gather path."""
    import jax

    from deeppreconditioning_tpu.ops.fsai import (
        build_range_fsai_plan,
        fsai_dense_preconditioner_range,
        fsai_values_range,
    )

    a = _poisson2d(16)  # banded ordering, n = 256
    n = a.shape[0]
    rows, cols, vals = _tril_sites(a)
    pr, pc = tril_power_pattern(rows, cols, n, power=3)
    plan_g = build_fsai_plan(rows, cols, pr, pc, n)
    plan_r = build_range_fsai_plan(pr, pc, n, block_cols=8)
    assert plan_r.range_h <= n

    c_g = np.asarray(
        fsai_values(plan_g, jnp.asarray(vals, jnp.float64))
    )
    a_dense = jnp.asarray(a.toarray(), jnp.float64)
    c_r = np.asarray(fsai_values_range(plan_r, a_dense))
    np.testing.assert_allclose(c_r, c_g, rtol=1e-9, atol=1e-12)

    m_g = np.asarray(fsai_dense_preconditioner(
        plan_g, jnp.asarray(vals, jnp.float64), dtype=jnp.float64
    ))
    m_r = np.asarray(fsai_dense_preconditioner_range(
        plan_r, a_dense, dtype=jnp.float64
    ))
    np.testing.assert_allclose(m_r, m_g, rtol=1e-9, atol=1e-10)

    # scaling fold + n0 mask parity
    rng = np.random.default_rng(0)
    d_isqrt = jnp.asarray(rng.random(n) + 0.5, jnp.float64)
    n0 = jnp.int32(n - 10)
    m_g = np.asarray(fsai_dense_preconditioner(
        plan_g, jnp.asarray(vals, jnp.float64), d_isqrt=d_isqrt,
        n0=n0, dtype=jnp.float64,
    ))
    m_r = np.asarray(fsai_dense_preconditioner_range(
        plan_r, a_dense, d_isqrt=d_isqrt, n0=n0, dtype=jnp.float64,
    ))
    np.testing.assert_allclose(m_r, m_g, rtol=1e-9, atol=1e-10)


def test_range_plan_rejects_nonbanded():
    import pytest

    from deeppreconditioning_tpu.ops.fsai import build_range_fsai_plan

    # an arrow pattern couples the last row to everything: spread = n
    n = 256
    rows = np.concatenate(
        [np.arange(n), np.full(n - 1, n - 1)]
    ).astype(np.int32)
    cols = np.concatenate(
        [np.arange(n), np.arange(n - 1)]
    ).astype(np.int32)
    with pytest.raises(ValueError):
        build_range_fsai_plan(rows, cols, n, range_h=128)


def test_fsai_padded_and_masked():
    """Identity padding rows and the n0 mask must stay decoupled."""
    a = _poisson2d(6)
    n0 = a.shape[0]
    n_pad = n0 + 28
    rows, cols, vals = _tril_sites(a)
    extra = np.arange(n0, n_pad, dtype=np.int32)
    rows_p = np.concatenate([rows, extra])
    cols_p = np.concatenate([cols, extra])
    vals_p = np.concatenate([vals, np.ones(extra.shape[0])])
    order = np.argsort(rows_p.astype(np.int64) * n_pad + cols_p)
    rows_p, cols_p, vals_p = (
        rows_p[order], cols_p[order], vals_p[order]
    )
    pr, pc = tril_power_pattern(rows_p, cols_p, n_pad, power=2)
    plan = build_fsai_plan(rows_p, cols_p, pr, pc, n_pad)
    m = np.asarray(
        fsai_dense_preconditioner(
            plan, jnp.asarray(vals_p),
            d_isqrt=jnp.ones(n_pad, jnp.float64),
            n0=jnp.int32(n0), dtype=jnp.float64,
        )
    )
    assert np.all(m[n0:, :] == 0) and np.all(m[:, n0:] == 0)
    eig = np.linalg.eigvalsh(m[:n0, :n0])
    assert eig.min() > 0


def test_poly_gram_form_matches_dense_factor_form():
    """poly_preconditioner_from_gram == poly_preconditioner_dense:
    C B^k C^T = (S A)^k S with S = C C^T (exact in reals)."""
    import jax.numpy as jnp
    import numpy as np
    from deeppreconditioning_tpu.ops.fsai import (
        poly_preconditioner_dense,
        poly_preconditioner_from_gram,
    )

    rng = np.random.default_rng(4)
    n = 24
    bmat = np.tril(rng.standard_normal((n, n)), -1) * 0.3 + np.eye(n)
    a = bmat @ bmat.T + 0.1 * np.eye(n)
    c = np.tril(rng.standard_normal((n, n)) * 0.1 + np.eye(n))
    q = np.array([0.8, -0.15, 0.02])
    d_isqrt = 1.0 / np.sqrt(np.diag(a))
    a_scaled = a * np.outer(d_isqrt, d_isqrt)

    m_dense = np.asarray(poly_preconditioner_dense(
        jnp.asarray(c, jnp.float64), jnp.asarray(a_scaled, jnp.float64),
        jnp.asarray(q, jnp.float64),
        d_isqrt=jnp.asarray(d_isqrt, jnp.float64),
    ))
    c_eff = d_isqrt[:, None] * c
    s_eff = c_eff @ c_eff.T
    m_gram = np.asarray(poly_preconditioner_from_gram(
        jnp.asarray(s_eff, jnp.float64), jnp.asarray(a, jnp.float64),
        jnp.asarray(q, jnp.float64),
    ))
    np.testing.assert_allclose(m_gram, m_dense, rtol=1e-10, atol=1e-12)


def test_fsai_values_lookup_matches_dense_variant():
    """The O(n w^2) sub_idx lookup path == the dense-row gather path."""
    import jax.numpy as jnp
    import numpy as np
    import scipy.sparse as sp
    from deeppreconditioning_tpu.ops.fsai import (
        build_fsai_plan,
        fsai_values,
        fsai_values_lookup,
        tril_power_pattern,
    )

    rng = np.random.default_rng(8)
    n = 40
    bmat = np.tril(rng.standard_normal((n, n)), -1)
    bmat[np.abs(bmat) < 1.2] = 0.0
    a = bmat @ bmat.T + np.eye(n) * 2.0
    coo = sp.coo_matrix(np.tril(a))
    order = np.argsort(coo.row.astype(np.int64) * n + coo.col)
    r0 = coo.row[order].astype(np.int32)
    c0 = coo.col[order].astype(np.int32)
    v0 = coo.data[order]
    pr, pc = tril_power_pattern(r0, c0, n, power=2)
    plan = build_fsai_plan(r0, c0, pr, pc, n)
    vals = jnp.asarray(v0, jnp.float64)
    c_dense, aux_d = fsai_values(plan, vals, with_aux=True)
    c_look, aux_l = fsai_values_lookup(plan, vals, with_aux=True)
    np.testing.assert_allclose(np.asarray(c_look), np.asarray(c_dense),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(np.asarray(aux_l), np.asarray(aux_d),
                               rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("w", [7, 13, 24])
def test_masked_gauss_jordan_pallas_interpret(w):
    """The batched local solves — the lane-major Gauss-Jordan and the
    row-major entry point that goes through it — solve SPD systems like
    numpy.linalg.solve at the widths the setups use."""
    import jax.numpy as jnp

    from deeppreconditioning_tpu.ops import gauss_jordan as gj

    rng = np.random.default_rng(w)
    n = 200
    a = rng.standard_normal((n, w, w))
    a = a @ a.transpose(0, 2, 1) + 3 * np.eye(w)
    e = np.zeros((n, w))
    e[np.arange(n), rng.integers(0, w, n)] = 1.0
    ref = np.linalg.solve(a, e[..., None])[..., 0]
    sub, rhs = jnp.asarray(a, jnp.float32), jnp.asarray(e, jnp.float32)
    lanes = gj.gauss_jordan_lanes(gj.to_lanes(sub, rhs))
    rows = gj.solve_batched(sub, rhs)
    # float32 elimination without pivoting on systems of condition
    # number up to ~1e3: ~1e-4 relative
    np.testing.assert_allclose(np.asarray(lanes).T, ref, rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_array_equal(np.asarray(rows), np.asarray(lanes).T)


@pytest.mark.parametrize("w", [4, 13])
def test_gauss_jordan_gradient_rule(w):
    """Autodiff through the unpivoted elimination gives the gradient of
    a linear solve (checked against jnp.linalg.solve's), for
    non-symmetric systems too."""
    import jax
    import jax.numpy as jnp

    from deeppreconditioning_tpu.ops import gauss_jordan as gj

    rng = np.random.default_rng(10 + w)
    n = 6
    sub = rng.standard_normal((n, w, w)) + 4 * np.eye(w)
    e = rng.standard_normal((n, w))
    wts = rng.standard_normal((n, w))

    def loss(solve, s, rhs):
        return jnp.sum(wts * jnp.sin(solve(s, rhs)))

    def lu(s, rhs):
        return jnp.linalg.solve(s, rhs[..., None])[..., 0]

    got = jax.grad(lambda s, r: loss(gj.solve_batched, s, r),
                   argnums=(0, 1))(jnp.asarray(sub), jnp.asarray(e))
    want = jax.grad(lambda s, r: loss(lu, s, r),
                    argnums=(0, 1))(jnp.asarray(sub), jnp.asarray(e))
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-9, atol=1e-11)
