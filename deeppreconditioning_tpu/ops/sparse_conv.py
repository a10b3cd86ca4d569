"""Sparse 2-D convolution as gather-GEMM over precomputed index plans.

JAX replacement for the spconv CUDA engine the reference models
ride on (reference: uibk/deep_preconditioning/model.py:27-40 uses
``SparseConv2d`` k in {1,2} with asymmetric padding; model.py:69-137 adds
``SubMConv2d``, strided ``SparseConv2d``, ``SparseInverseConv2d`` and
``sparse_add`` for the U-Net).

Design: spconv splits sparse convolution into (a) a host/native "indice
generation" step that builds gather/scatter index pairs from the sparsity
pattern and (b) device gather-GEMM-scatter using those pairs.  XLA wants
static shapes, so we make the split explicit and ahead-of-time:

  * host map builders (numpy / native C++) compute, per layer, the output
    active set and one gather map per kernel offset.  A matrix's sparsity
    pattern is fixed for its lifetime, so plans are built once per sample
    and cached — unlike the reference, which regenerates indices every
    forward pass;
  * `apply_sparse_conv` (device) computes
    ``out = sum_k features[gather[k]] @ W[k] + b`` — K gathers plus K
    (nnz x Cin) @ (Cin x Cout) matmuls that XLA fuses.  Stride-1 semantics mean each output site receives at most one
    contribution per kernel offset, so no scatter is ever needed.

Topology is expressed through *site-set levels*: every layer maps one
level (its input active set) to another (its output active set).  A plain
chain (PreconditionerNet) has levels 0,1,2,...; the U-Net re-uses levels
for skip connections (SparseInverseConv restores a previous level, so
sparse_add operands share a site set and reduce to plain addition).  nnz
is padded per-level to static buckets; the sentinel gather index points
at an all-zero feature row, so padding is inert.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from deeppreconditioning_tpu.utils import struct


@dataclass(frozen=True)
class ConvSpec:
    """Static description of one sparse-conv layer.

    submanifold=True keeps the output active set equal to the input set
    (spconv SubMConv2d); stride>1 downsamples (spconv SparseConv2d with
    stride).
    """

    kernel: Tuple[int, int]
    padding: Tuple[int, int]
    stride: int = 1
    submanifold: bool = False

    def out_shape(self, hw: Tuple[int, int]) -> Tuple[int, int]:
        if self.submanifold:
            return hw
        kh, kw = self.kernel
        ph, pw = self.padding
        s = self.stride
        return (
            (hw[0] + 2 * ph - kh) // s + 1,
            (hw[1] + 2 * pw - kw) // s + 1,
        )


@struct.dataclass
class LayerPlan:
    """Device-side index plan for one conv layer on one sample.

    Attributes:
        gather: int32 (K, nnz_out_pad) — for each kernel offset, the index
            into the (zero-row-extended) input feature array; sentinel =
            input-level bucket size points at the zero row.
        rows, cols: int32 (nnz_out_pad,) — output site coordinates.
        valid: bool (nnz_out_pad,) — real output sites.
    """

    gather: jax.Array
    rows: jax.Array
    cols: jax.Array
    valid: jax.Array


def _lookup(lin_sorted, order, cand, inb):
    """Map candidate linearized sites to input indices (-1 if absent)."""
    nnz_in = lin_sorted.shape[0]
    if nnz_in == 0:
        return np.full(cand.shape, -1, np.int32)
    pos = np.searchsorted(lin_sorted, cand)
    pos_c = np.clip(pos, 0, nnz_in - 1)
    found = inb & (pos < nnz_in) & (lin_sorted[pos_c] == cand)
    return np.where(found, order[pos_c], -1).astype(np.int32)


def build_conv_maps(
    rows: np.ndarray,
    cols: np.ndarray,
    hw_in: Tuple[int, int],
    spec: ConvSpec,
) -> tuple:
    """Output active set + gather maps for an (optionally strided /
    submanifold) conv layer (host; native C++ for the stride-1 ordinary
    case).

    Ordinary conv: out(i,j) = sum_{ki,kj} in(i*s - ph + ki, j*s - pw + kj)
    so the output set is the input set pushed through the kernel
    footprint; submanifold: out set == in set with the same kernel sum.

    Returns (out_rows, out_cols, gather (K, nnz_out), hw_out).
    """
    kh, kw = spec.kernel
    ph, pw = spec.padding
    s = spec.stride
    h_out, w_out = spec.out_shape(hw_in)
    w_in = hw_in[1]

    if (not spec.submanifold) and s == 1:
        from deeppreconditioning_tpu import native

        if native.available() and rows.shape[0] > 0:
            lin = rows.astype(np.int64) * w_in + cols
            if np.all(lin[:-1] <= lin[1:]):
                o_rows, o_cols, gather = native.conv_plan(
                    rows, cols, hw_in[0], w_in, kh, kw, ph, pw
                )
                return o_rows, o_cols, gather, (h_out, w_out)

    lin_in = rows.astype(np.int64) * w_in + cols
    order = np.argsort(lin_in, kind="stable").astype(np.int32)
    lin_sorted = lin_in[order]

    if spec.submanifold:
        out_rows = rows.astype(np.int32)
        out_cols = cols.astype(np.int32)
    else:
        parts = []
        for ki in range(kh):
            for kj in range(kw):
                ro = rows.astype(np.int64) + ph - ki
                co = cols.astype(np.int64) + pw - kj
                if s > 1:
                    div = (ro % s == 0) & (co % s == 0)
                    ro, co = ro[div] // s, co[div] // s
                ok = (ro >= 0) & (ro < h_out) & (co >= 0) & (co < w_out)
                parts.append(ro[ok] * w_out + co[ok])
        out_lin = (
            np.unique(np.concatenate(parts)) if parts else
            np.empty(0, np.int64)
        )
        out_rows = (out_lin // w_out).astype(np.int32)
        out_cols = (out_lin % w_out).astype(np.int32)

    nnz_out = out_rows.shape[0]
    gather = np.empty((kh * kw, nnz_out), np.int32)
    for k, (ki, kj) in enumerate(
        (a, b) for a in range(kh) for b in range(kw)
    ):
        ri = out_rows.astype(np.int64) * s - ph + ki
        ci = out_cols.astype(np.int64) * s - pw + kj
        inb = (ri >= 0) & (ri < hw_in[0]) & (ci >= 0) & (ci < w_in)
        cand = ri * w_in + ci
        gather[k] = _lookup(lin_sorted, order, cand, inb)
    return out_rows, out_cols, gather, (h_out, w_out)


def build_inverse_conv_maps(
    down_rows: np.ndarray,
    down_cols: np.ndarray,
    hw_down: Tuple[int, int],
    orig_rows: np.ndarray,
    orig_cols: np.ndarray,
    spec: ConvSpec,
) -> np.ndarray:
    """Gather maps for SparseInverseConv2d (spconv indice_key semantics).

    The inverse conv restores exactly the *input* active set of the
    matching strided conv: output sites = orig sites; contribution at
    orig site o from downsampled site d via kernel offset (ki, kj) exists
    iff the forward conv mapped o into d through that offset, i.e.
    d_r * s - ph + ki == o_r (same for columns).

    Returns gather (K, nnz_orig) into the downsampled feature array.
    """
    kh, kw = spec.kernel
    ph, pw = spec.padding
    s = spec.stride
    w_down = hw_down[1]

    lin_down = down_rows.astype(np.int64) * w_down + down_cols
    order = np.argsort(lin_down, kind="stable").astype(np.int32)
    lin_sorted = lin_down[order]

    nnz = orig_rows.shape[0]
    gather = np.empty((kh * kw, nnz), np.int32)
    for k, (ki, kj) in enumerate(
        (a, b) for a in range(kh) for b in range(kw)
    ):
        num_r = orig_rows.astype(np.int64) + ph - ki
        num_c = orig_cols.astype(np.int64) + pw - kj
        div = (num_r % s == 0) & (num_c % s == 0)
        dr = num_r // s
        dc = num_c // s
        inb = div & (dr >= 0) & (dr < hw_down[0]) & (dc >= 0) & (
            dc < w_down
        )
        cand = dr * w_down + dc
        gather[k] = _lookup(lin_sorted, order, cand, inb)
    return gather


@dataclass
class SamplePlanHost:
    """Host-side plan for a full network on one sample (pre-padding).

    Topology is encoded by in_level/out_level: layer li gathers from the
    feature array living on level in_level[li] and produces the array on
    level out_level[li].  level_nnz[lv] is the site count of level lv
    (level 0 = the network input).
    """

    layer_rows: List[np.ndarray] = field(default_factory=list)
    layer_cols: List[np.ndarray] = field(default_factory=list)
    layer_gather: List[np.ndarray] = field(default_factory=list)
    shapes: List[Tuple[int, int]] = field(default_factory=list)
    in_level: List[int] = field(default_factory=list)
    out_level: List[int] = field(default_factory=list)
    level_nnz: List[int] = field(default_factory=list)


def build_sample_plan(
    rows: np.ndarray,
    cols: np.ndarray,
    hw: Tuple[int, int],
    specs: Sequence[ConvSpec],
) -> SamplePlanHost:
    """Chain layer plans through a sequential network for one sample."""
    cur_rows, cur_cols = rows.astype(np.int32), cols.astype(np.int32)
    cur_hw = hw
    out = SamplePlanHost(shapes=[hw], level_nnz=[rows.shape[0]])
    for li, spec in enumerate(specs):
        if spec.kernel == (1, 1) and spec.padding == (0, 0) \
                and not spec.submanifold and spec.stride == 1:
            gather = np.arange(cur_rows.shape[0], dtype=np.int32)[None, :]
            o_rows, o_cols = cur_rows, cur_cols
        else:
            o_rows, o_cols, gather, cur_hw = build_conv_maps(
                cur_rows, cur_cols, cur_hw, spec
            )
        out.layer_rows.append(o_rows)
        out.layer_cols.append(o_cols)
        out.layer_gather.append(gather)
        out.shapes.append(cur_hw)
        out.in_level.append(li)
        out.out_level.append(li + 1)
        out.level_nnz.append(o_rows.shape[0])
        cur_rows, cur_cols = o_rows, o_cols
    return out


def pad_plans_by_level(
    plans: Sequence[SamplePlanHost],
    level_buckets: Sequence[int],
) -> List[List[LayerPlan]]:
    """Pad per-sample plans to shared per-level buckets for vmap.

    level_buckets[lv] is the padded nnz of the feature array on level lv
    (computed dataset-wide so every batch shares shapes).  Gather
    sentinels point at index level_buckets[in_level] — the appended zero
    row of that level's feature array.
    """
    result: List[List[LayerPlan]] = []
    for p in plans:
        sample_layers: List[LayerPlan] = []
        for li in range(len(p.layer_rows)):
            nnz_out = p.layer_rows[li].shape[0]
            np_out = level_buckets[p.out_level[li]]
            sentinel = level_buckets[p.in_level[li]]
            g = p.layer_gather[li]
            gather = np.full((g.shape[0], np_out), sentinel, np.int32)
            gather[:, :nnz_out] = np.where(g >= 0, g, sentinel)
            rows = np.zeros((np_out,), np.int32)
            cols = np.zeros((np_out,), np.int32)
            rows[:nnz_out] = p.layer_rows[li]
            cols[:nnz_out] = p.layer_cols[li]
            valid = np.zeros((np_out,), bool)
            valid[:nnz_out] = True
            sample_layers.append(
                LayerPlan(
                    gather=jnp.asarray(gather),
                    rows=jnp.asarray(rows),
                    cols=jnp.asarray(cols),
                    valid=jnp.asarray(valid),
                )
            )
        result.append(sample_layers)
    return result


def pad_sample_plans(
    plans: Sequence[SamplePlanHost],
    nnz0: Sequence[int],
    bucket: int = 256,
) -> List[List[LayerPlan]]:
    """Pad plans to buckets derived from these samples alone (convenience
    wrapper over pad_plans_by_level for tests/one-off use; datasets
    compute dataset-global buckets instead)."""
    n_levels = max(max(p.out_level) for p in plans) + 1
    buckets = []
    for lv in range(n_levels):
        m = max(p.level_nnz[lv] for p in plans)
        if lv == 0:
            m = max(m, max(nnz0))
        buckets.append(_round_up(m, bucket))
    return pad_plans_by_level(plans, buckets)


def stack_plans(
    plans_padded: List[List[LayerPlan]],
) -> List[LayerPlan]:
    """Stack per-sample LayerPlans into batched (B, ...) LayerPlans."""
    n_layers = len(plans_padded[0])
    return [
        jax.tree.map(lambda *xs: jnp.stack(xs), *[p[li] for p in plans_padded])
        for li in range(n_layers)
    ]


def _round_up(n: int, m: int) -> int:
    return ((max(n, 1) + m - 1) // m) * m


def apply_sparse_conv(
    features: jax.Array,  # (nnz_in_pad, Cin)
    plan: LayerPlan,
    weights: jax.Array,  # (K, Cin, Cout)
    bias: jax.Array | None,  # (Cout,)
) -> jax.Array:
    """Device gather-GEMM for one layer on one sample.

    Returns (nnz_out_pad, Cout).  Bias is only added at valid sites (spconv
    adds bias per active output site; padded rows must stay zero).
    """
    feat_ext = jnp.concatenate(
        [features, jnp.zeros((1, features.shape[1]), features.dtype)], axis=0
    )
    k = weights.shape[0]
    out = jnp.zeros((plan.gather.shape[1], weights.shape[2]), features.dtype)
    for i in range(k):
        out = out + jnp.matmul(feat_ext[plan.gather[i]], weights[i],
                               precision=jax.lax.Precision.HIGHEST)
    if bias is not None:
        out = out + bias[None, :]
    return jnp.where(plan.valid[:, None], out, 0)
