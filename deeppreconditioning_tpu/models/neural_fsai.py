"""NeuralFSAI — FSAI local solves + learned refinement + polynomial wrap.

A third model family beyond the reference's two CNNs (framework
extension; reference model.py:13-179 only offers conv nets, whose output
pattern is the conv-dilated band — measurably weaker than the graph
pattern tril(|A|^p)).  Three composable parts:

1. **FSAI base** (ops/fsai.py): batched local Cholesky solves — the
   exact Kaporin-optimal column values on the pattern.
2. **Per-column refinement MLP**: sees the normalized base column
   *and* the local structure of A (the pattern column A~[S_j, j]) and
   emits per-slot corrections

       c_ref = c * exp(alpha)                 on the diagonal slot
       c_ref = c * exp(alpha) + beta * c_diag elsewhere on the pattern

   alpha/beta are zero-initialized, so the untrained refinement is the
   identity.
3. **Learned polynomial wrap** (q_coeffs): the deployed preconditioner
   is M = C q(B) q(B)^T C^T with B = C^T A~ C and q a small learned
   polynomial (init q = I) — SPD for any coefficients, and exactly FSAI
   when untrained.  At benchmark sizes M is materialized at setup with a
   few dense matmuls, so the wrap buys its iteration reduction at
   unchanged per-iteration cost (ops/fsai.poly_preconditioner_dense);
   at scale it is applied in factor form as alternating C / A / C^T
   sparse applies (ops/factor_apply.py).

Trained end-to-end with the unrolled-PCG residual loss
(metrics.pcg_residual_loss) — a differentiable proxy for the deployed
CG iteration count (the reference's validation metric,
train.py:102-108) — so training can beat the classical Kaporin optimum
on the metric that is actually measured.

Everything is (n_pad, w)-shaped with dataset-global static width w, so
the whole setup — local solves + MLP + wrap — is one compiled executable
reused across cases, exactly like the conv models' gather-GEMM plans.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from deeppreconditioning_tpu.models.precond_net import param_key
from deeppreconditioning_tpu.ops.fsai import (
    FSAIPlan,
    RangeFSAIPlan,
    build_fsai_plan,
    build_range_fsai_plan,
    fsai_dense_factor,
    fsai_dense_from_l0,
    fsai_values,
    pattern_col_width,
    poly_preconditioner_dense,
    poly_preconditioner_from_gram,
    range_dense_factor_slabs,
    range_fsai_columns,
    range_m_from_strips,
    range_strips,
    tril_power_pattern,
)


class NeuralFSAIOut(NamedTuple):
    """Model output: refined factor columns + polynomial coefficients."""

    c_vals: jax.Array  # (n_pad, w) refined column values of C
    q_coeffs: jax.Array  # (poly_degree + 1,) coefficients of q


def _dense(p, x):
    # HIGHEST: a float32 product on the GPU would otherwise run in TF32
    return jnp.dot(x, p["kernel"],
                   precision=jax.lax.Precision.HIGHEST) + p["bias"]


@dataclasses.dataclass(frozen=True)
class NeuralFSAI:
    """FSAI base + zero-init learned refinement + learned polynomial wrap
    (see module docstring).

    ``init(key, plan, operand)`` returns the variables
    ``{"params": {dense0, dense1, alpha, beta: {kernel, bias},
    q_coeffs}}``; ``apply(variables, plan, operand)`` runs one sample
    (vmap for batches):
        plan: FSAIPlan (operand = (nnz0_pad,) scaled tril values) or
            RangeFSAIPlan (operand = dense scaled symmetric matrix —
            the banded fast path, ops/fsai.py).  Column width must
            equal self.width in both cases.
    Returns NeuralFSAIOut.  Untrained output reproduces classical FSAI
    exactly: alpha = beta = 0 and q = I.
    """

    width: int
    hidden: int = 64
    poly_degree: int = 1  # degree of q; 0 disables the wrap
    gather: str = "rows"  # FSAIPlan submatrix extraction: "rows" (dense
    # row gather + one-hot select — fastest single-case, but its
    # one-hot is O(n_pad^2 w) memory) or "lookup" (plan.sub_idx element
    # gather, O(n_pad w^2) — required when vmapping over many cases).
    # Pure tracing choice; parameters are identical across variants.

    def init(self, key, plan, operand: jax.Array) -> dict:
        """Lecun-normal hidden kernels, zero biases, zero refinement
        heads and zero polynomial delta (the untrained model is FSAI)."""
        del plan
        w, h = self.width, self.hidden
        k0, k1 = param_key(key, "dense0", 1), param_key(key, "dense1", 1)
        lecun = jax.nn.initializers.lecun_normal()
        dtype = jnp.asarray(operand).dtype

        def zeros_dense(n_in, n_out):
            return {"kernel": jnp.zeros((n_in, n_out), jnp.float32),
                    "bias": jnp.zeros((n_out,), jnp.float32)}

        return {"params": {
            "dense0": {"kernel": lecun(k0, (4 * w, h), jnp.float32),
                       "bias": jnp.zeros((h,), jnp.float32)},
            "dense1": {"kernel": lecun(k1, (h, h), jnp.float32),
                       "bias": jnp.zeros((h,), jnp.float32)},
            "alpha": zeros_dense(h, w),
            "beta": zeros_dense(h, w),
            "q_coeffs": jnp.zeros((self.poly_degree + 1,), dtype),
        }}

    def apply(self, variables, plan, operand: jax.Array) -> NeuralFSAIOut:
        p = variables["params"]
        w = self.width
        assert plan.width == w, (plan.width, w)
        if isinstance(plan, RangeFSAIPlan):
            c, a_col = range_fsai_columns(plan, operand, with_aux=True)
        elif self.gather == "lookup":
            from deeppreconditioning_tpu.ops.fsai import fsai_values_lookup

            c, a_col = fsai_values_lookup(plan, operand, with_aux=True)
        else:
            c, a_col = fsai_values(plan, operand, with_aux=True)

        pad = plan.diag_pad
        pos1h = jax.nn.one_hot(plan.pos, w, dtype=c.dtype)
        # masked-sum slot extraction: one fused elementwise pass instead
        # of a batched take_along_axis gather
        c_diag = jnp.sum(c * pos1h, axis=1, keepdims=True)
        denom = jnp.maximum(jnp.abs(c_diag), 1e-20)
        feats = jnp.concatenate(
            [c / denom, a_col, pos1h, pad], axis=1
        )

        h = jax.nn.gelu(_dense(p["dense0"], feats))
        h = jax.nn.gelu(_dense(p["dense1"], h))
        alpha = _dense(p["alpha"], h)
        beta = _dense(p["beta"], h)

        live = (plan.out_rows < plan.n_pad).astype(c.dtype) * (1.0 - pad)
        refined = c * jnp.exp(alpha) + (1.0 - pos1h) * beta * c_diag
        c_out = refined * live

        # q(B) coefficients: identity + trainable (zero-init) delta
        q0 = jnp.zeros((self.poly_degree + 1,), c.dtype).at[0].set(1.0)
        return NeuralFSAIOut(c_vals=c_out, q_coeffs=q0 + p["q_coeffs"])


def batched_apply_fsai(model: NeuralFSAI, params, plans,
                       operands: jax.Array) -> NeuralFSAIOut:
    """vmap the model over a batch of stacked plans + operands
    (value vectors for FSAIPlan, dense scaled A for RangeFSAIPlan)."""
    return jax.vmap(
        lambda p, v: model.apply(params, p, v)
    )(plans, operands)


def batched_dense_factor(plans, c_vals: jax.Array,
                         d_isqrt=None, n0=None) -> jax.Array:
    """vmapped dense C build -> (B, n_pad, n_pad), plan-type dispatched."""
    factor = (range_dense_factor_slabs
              if isinstance(plans, RangeFSAIPlan) else fsai_dense_factor)
    if d_isqrt is None:
        return jax.vmap(lambda p, c: factor(p, c))(plans, c_vals)
    return jax.vmap(factor)(plans, c_vals, d_isqrt, n0)


def batched_dense_m(plans, out: NeuralFSAIOut, a_full: jax.Array
                    ) -> jax.Array:
    """Batched dense preconditioner M~ = C q(B) q(B)^T C^T in scaled
    space: the training/validation-side analog of the suite's
    _neural_fsai_setup_device (no scaling fold, no n0 mask — the scaled
    systems are what training solves)."""
    c_dense = batched_dense_factor(plans, out.c_vals)
    return jax.vmap(poly_preconditioner_dense)(
        c_dense, a_full, out.q_coeffs
    )


def neural_fsai_dense_preconditioner(
    model: NeuralFSAI,
    params,
    plan,
    operand: jax.Array,
    scales: jax.Array,
    n0,
    dtype=jnp.float32,
    precision=None,
) -> jax.Array:
    """Single-sample deployed setup: model forward -> dense effective
    preconditioner on the RAW system (scaling folded, padding masked) —
    the NeuralFSAI analog of fsai_dense_preconditioner."""
    out = model.apply(params, plan, operand.astype(dtype))
    d_isqrt = 1.0 / jnp.sqrt(scales.astype(dtype))
    if isinstance(plan, RangeFSAIPlan):
        # Gram form: assemble S = C_eff C_eff^T directly from strips
        # (the classical setup's slab op) and apply the polynomial as
        # 2d+1 extra matmuls — no dense factor C materialization
        strips = range_strips(plan, out.c_vals)
        s_eff = range_m_from_strips(
            plan, strips, d_isqrt=d_isqrt, n0=n0
        )
        d_sqrt = jnp.sqrt(scales.astype(dtype))
        a_raw = d_sqrt[:, None] * operand.astype(dtype) * d_sqrt[None, :]
        return poly_preconditioner_from_gram(
            s_eff, a_raw, out.q_coeffs, precision=precision
        )
    a_dense = fsai_dense_from_l0(plan, operand.astype(dtype))
    c_dense = fsai_dense_factor(plan, out.c_vals)
    return poly_preconditioner_dense(
        c_dense, a_dense, out.q_coeffs, d_isqrt=d_isqrt, n0=n0,
        precision=precision,
    )


def neural_fsai_case_setup(
    model: NeuralFSAI,
    params,
    a_csr,  # scipy CSR raw system
    power: int,
    dtype=jnp.float32,
):
    """Per-case deployed setup from a raw scipy system: Jacobi-scale,
    build the (width-capped) FSAI plan, model forward, fold the scaling
    — returns (m, n_pad): the dense effective preconditioner for the
    RAW system, padded.  The shared host path of compare_meshes.py and
    residual_parity.py (one-off cases outside a PlannedDataSet)."""
    from deeppreconditioning_tpu.ops.fsai import (
        fsai_dense_from_l0,
        poly_preconditioner_dense,
        tril_power_pattern_capped,
    )

    a = a_csr.tocsr()
    n = a.shape[0]
    coo = a.tocoo()
    keep = coo.row >= coo.col
    rows, cols = coo.row[keep], coo.col[keep]
    vals = coo.data[keep]
    diag = a.diagonal()
    d_isqrt = 1.0 / np.sqrt(diag)
    vals = vals * d_isqrt[rows] * d_isqrt[cols]

    n_pad = ((n + 127) // 128) * 128
    pad_ids = np.arange(n, n_pad, dtype=np.int32)
    l0_rows = np.concatenate([rows.astype(np.int32), pad_ids])
    l0_cols = np.concatenate([cols.astype(np.int32), pad_ids])
    l0_vals = np.concatenate([vals, np.ones(n_pad - n)])
    order = np.argsort(l0_rows.astype(np.int64) * n_pad + l0_cols)
    l0_rows, l0_cols = l0_rows[order], l0_cols[order]
    l0_vals = l0_vals[order]

    pr, pc = tril_power_pattern(l0_rows, l0_cols, n_pad, power=power)
    if pattern_col_width(pr, pc) > model.width:
        pr, pc = tril_power_pattern_capped(
            l0_rows, l0_cols, l0_vals, n_pad,
            power=power, width=model.width,
        )
    plan = build_fsai_plan(
        l0_rows, l0_cols, pr, pc, n_pad, width=model.width
    )
    operand = jnp.asarray(l0_vals, dtype)
    p = jax.tree.map(lambda x: jnp.asarray(x).astype(dtype)
                     if jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating)
                     else x, params)
    out = model.apply(p, plan, operand)
    c = fsai_dense_factor(plan, out.c_vals)
    a_dense = fsai_dense_from_l0(plan, operand)
    d_isqrt_pad = np.ones(n_pad)
    d_isqrt_pad[:n] = d_isqrt
    m = poly_preconditioner_dense(
        c, a_dense, out.q_coeffs,
        d_isqrt=jnp.asarray(d_isqrt_pad, dtype),
        n0=jnp.int32(n),
    )
    return m, n_pad


def stack_fsai_plans(plans: Sequence[FSAIPlan]) -> FSAIPlan:
    """Stack per-sample plans (same static shapes) into one batched plan."""
    return jax.tree.map(lambda *xs: jnp.stack(xs), *plans)


class FSAIPlanProvider:
    """Builds and caches batched FSAIPlans for a PlannedDataSet.

    The dataset's level-0 conv plan already carries the tril(A) sites in
    feature order; this provider derives the FSAI pattern/plan per sample
    and stacks them per batch — the FSAI analog of the dataset's conv
    plans (built once, reused every epoch).
    """

    def __init__(self, dataset, power: int = 3, width: int = 16,
                 range_h: int = 256, kind: str = "auto"):
        self.dataset = dataset
        self.power = power
        self.width = width
        self.range_h = range_h
        self.kind = kind  # "auto" | "range" | "generic"
        self._cache: dict = {}

    def _sample_plan(self, rows, cols, valid, n_pad, sentinel):
        nnz = int(valid.sum())
        r0 = rows[:nnz].astype(np.int32)
        c0 = cols[:nnz].astype(np.int32)
        pr, pc = tril_power_pattern(r0, c0, n_pad, power=self.power)
        need = pattern_col_width(pr, pc)
        if need > self.width:
            raise ValueError(
                f"fsai pattern width {need} exceeds configured width "
                f"{self.width}; raise params fsai_width"
            )
        if self.kind == "auto":
            try:
                plan = build_range_fsai_plan(
                    pr, pc, n_pad, width=self.width,
                    range_h=min(self.range_h, n_pad),
                )
                self.kind = "range"
                return plan
            except ValueError:
                self.kind = "generic"
        if self.kind == "range":
            return build_range_fsai_plan(
                pr, pc, n_pad, width=self.width,
                range_h=min(self.range_h, n_pad),
            )
        return build_fsai_plan(
            r0, c0, pr, pc, n_pad, width=self.width, sentinel=sentinel
        )

    def __call__(self, index: int, batch) -> FSAIPlan:
        # key on batch identity, not index: dataset views (train/val
        # splits) renumber batches but share the base dataset's lru cache
        del index
        key = id(batch.features)
        if key in self._cache:
            return self._cache[key]
        p0 = batch.plans[0]
        n_pad = batch.solutions.shape[1]
        sentinel = batch.features.shape[1]
        plans: List[FSAIPlan] = []
        for b in range(batch.features.shape[0]):
            plans.append(self._sample_plan(
                np.asarray(p0.rows[b]),
                np.asarray(p0.cols[b]),
                np.asarray(p0.valid[b]),
                n_pad,
                sentinel,
            ))
        plan = stack_fsai_plans(plans)
        self._cache[key] = plan
        return plan
