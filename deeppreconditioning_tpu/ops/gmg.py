"""Geometric multigrid on structured DIA operators — zero-gather MG.

The aggregation AMG (ops/amg.py, the pyamg-class replacement for the
reference's disabled baseline, uibk/deep_preconditioning/test.py:95-98)
is mesh-agnostic but pays unstructured gathers in its transfers at
scale.  On the *structured* scaling family (BASELINE.md:
uniform-grid variable-coefficient Poisson) every MG ingredient has a
gather-free form:

  * coarsening is 2x per axis with piecewise-constant aggregates, so
    restriction is a (X/2, 2, Y/2, 2, Z/2, 2) reshape-sum and
    prolongation a broadcast — pure layout ops;
  * the Galerkin coarse operator P^T A P of a 7-point DIA operator is
    again a 7-point DIA operator whose bands are reshape-sums of the
    fine bands (axis-aligned edges either stay inside an aggregate —
    feeding the coarse diagonal — or connect adjacent aggregates —
    feeding the coarse band);
  * smoothing is damped Jacobi (one DIA SpMV) or the structured FSAI
    factor S = C C^T (two more band sweeps, ops/structured_fsai.py) —
    including the TRAINED width-local NeuralFSAI head, which applies
    unchanged at every level because each coarse operator is again a
    7-point variable-coefficient stencil.

One symmetric V(1,1)-cycle is the PCG preconditioner (same symmetry
argument as ops/amg.amg_apply: symmetric smoothers, transpose-pair
transfers, symmetric dense root inverse).  At 128^3 the whole cycle
costs a handful of DIA band sweeps — the technique that converts the
random-rhs family's 248 Jacobi iterations into ~10.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from deeppreconditioning_tpu.utils import struct

from deeppreconditioning_tpu.sparse.dia import DIAMatrix


def _pad_to(n: int, mult: int = 1024) -> int:
    return ((n + mult - 1) // mult) * mult


def _axis_offsets(shape: Sequence[int]) -> Tuple[int, ...]:
    """Positive linear offsets of the 7-point stencil, x-major order
    (matching data/poisson.py's strides)."""
    nd = len(shape)
    return tuple(
        int(np.prod(shape[ax + 1:])) for ax in range(nd)
    )


@struct.dataclass
class GMGLevel:
    """One level: its DIA operator + smoother data.

    ``smoother`` bands are ``None`` for Jacobi smoothing, else the
    structured-FSAI factor in (C^T, C) DIA-view form.
    """

    a: DIAMatrix
    inv_diag: jax.Array
    c_up: Optional[DIAMatrix]
    c_low: Optional[DIAMatrix]
    shape: Tuple[int, ...] = struct.field(pytree_node=False)
    omega: float = struct.field(pytree_node=False)


@struct.dataclass
class GMGPreconditioner:
    levels: Tuple[GMGLevel, ...]
    coarse_inv: jax.Array  # (nc, nc) dense root inverse
    coarse_shape: Tuple[int, ...] = struct.field(pytree_node=False)


def _grid_view(x: jax.Array, shape) -> jax.Array:
    n = int(np.prod(shape))
    return x[:n].reshape(shape)


def _pair_np(z: int) -> np.ndarray:
    """(z, z/2) 0/1 aggregation matrix: column j sums entries 2j,
    2j+1."""
    m = np.zeros((z, z // 2), np.float32)
    m[np.arange(z), np.arange(z) // 2] = 1.0
    return m


def _restrict_grid(g: jax.Array, shape) -> jax.Array:
    """Aggregate-sum a fine GRID to the coarse grid, lane-friendly.

    Leading axes pair-sum via reshape; the minor axis contracts
    against a 0/1 pairing matrix instead of splitting the minor
    dimension 2-way (a strided shuffle).  Precision.HIGHEST keeps the
    matmul an exact f32 sum — a reduced-precision pass (TF32 on the
    GPU) would round the operand.
    """
    shape = tuple(int(s) for s in shape)
    nd = len(shape)
    if nd > 1:
        new = []
        for s in shape[:-1]:
            new += [s // 2, 2]
        new.append(shape[-1])
        g = g.reshape(new).sum(
            axis=tuple(range(1, 2 * (nd - 1), 2))
        )
    rz = jnp.asarray(_pair_np(shape[-1]), g.dtype)
    return jnp.matmul(g, rz, precision=jax.lax.Precision.HIGHEST)


def galerkin_coarse_dia(a: DIAMatrix, shape) -> DIAMatrix:
    """P^T A P for piecewise-constant 2x-per-axis aggregates, DIA in,
    DIA out — reshape-sums on major axes + a pair-contraction on the
    minor axis (see _restrict_grid), no gather.

    For an axis-aligned band value v[i] coupling cell i -> i + e_ax:
    the pair lives inside one aggregate iff i's coordinate along ax is
    even; those values sum (twice, for both triangle halves) into the
    coarse diagonal, the odd-coordinate values sum into the coarse
    band along ax — expressed here as parity-masked restrictions of
    the band grid.  The diagonal restricts by plain aggregate sum.
    Requires every grid dimension even (callers stop coarsening when
    one is not).
    """
    shape = tuple(int(s) for s in shape)
    nd = len(shape)
    assert all(s % 2 == 0 for s in shape)
    cshape = tuple(s // 2 for s in shape)
    nc = int(np.prod(cshape))
    n_pad_c = _pad_to(nc)
    offs = _axis_offsets(shape)
    offs_c = _axis_offsets(cshape)
    pos = {offs[ax]: ax for ax in range(nd)}

    diag_c = jnp.zeros(cshape, a.vals.dtype)
    bands_c = {}
    for d, off in enumerate(a.offsets):
        g = _grid_view(a.vals[d], shape)
        if off == 0:
            diag_c = diag_c + _restrict_grid(g, shape)
        elif off in pos:
            ax = pos[off]
            # parity mask along ax: 0 at even fine coordinates
            par = (jnp.arange(shape[ax]) % 2).astype(g.dtype)
            par = par.reshape(
                [shape[ax] if i == ax else 1 for i in range(nd)]
            )
            intra = _restrict_grid(g * (1.0 - par), shape)
            inter = _restrict_grid(g * par, shape)
            # intra-aggregate edges: both (i,j) and (j,i) fold into
            # the coarse diagonal
            diag_c = diag_c + 2.0 * intra
            bands_c[offs_c[ax]] = inter
        # negative offsets are the mirrors of the positive bands; the
        # symmetric coarse operator is assembled from the positive
        # halves below, so they are skipped (their contributions are
        # identical by symmetry)

    # assemble symmetric coarse DIA (offsets sorted ascending)
    n = int(np.prod(shape))
    del n
    vals = []
    offsets = []
    for ax in range(nd):
        oc = offs_c[ax]
        band = bands_c.get(
            oc, jnp.zeros(cshape, a.vals.dtype)
        ).reshape(-1)
        # vals[d, i] multiplies x[i + off]: positive band at i (valid
        # where the neighbor exists — the reshape-sum already left
        # zeros at the boundary because fine bands store 0 there)
        vals.append((oc, jnp.pad(band, (0, n_pad_c - nc))))
        # negative band: A[i, i-oc] = A[i-oc, i] = pos_band[i-oc]
        neg = jnp.pad(band, (0, n_pad_c - nc))
        neg = jnp.pad(neg[:n_pad_c - oc], (oc, 0))
        vals.append((-oc, neg))
    vals.append((0, jnp.pad(diag_c.reshape(-1), (0, n_pad_c - nc))))
    vals.sort(key=lambda t: t[0])
    return DIAMatrix(
        vals=jnp.stack([v for _, v in vals]),
        offsets=tuple(o for o, _ in vals),
        n=nc,
    )


def restrict_pc(r: jax.Array, shape) -> jax.Array:
    """P^T r: aggregate sums, lane-friendly (fine (n_pad,) -> coarse
    (n_pad_c,)); see _restrict_grid for the layout rationale."""
    shape = tuple(int(s) for s in shape)
    cshape = tuple(s // 2 for s in shape)
    nc = int(np.prod(cshape))
    rc = _restrict_grid(_grid_view(r, shape), shape)
    return jnp.pad(rc.reshape(-1), (0, _pad_to(nc) - nc))


def prolong_pc(xc: jax.Array, shape) -> jax.Array:
    """P xc: broadcast each aggregate value to its 2^nd fine cells.

    Transpose of restrict_pc in the same form: the minor axis expands
    against the pairing matrix's transpose (instead of a jnp.repeat
    interleave on the minor axis), the leading axes by broadcast +
    reshape.
    """
    shape = tuple(int(s) for s in shape)
    nd = len(shape)
    cshape = tuple(s // 2 for s in shape)
    n = int(np.prod(shape))
    g = _grid_view(xc, cshape)
    rz = jnp.asarray(_pair_np(shape[-1]), g.dtype)
    g = jnp.matmul(g, rz.T, precision=jax.lax.Precision.HIGHEST)
    if nd > 1:
        tgt = []
        for s in shape[:-1]:
            tgt += [s // 2, 2]
        tgt.append(shape[-1])
        for i in range(nd - 1):
            g = jnp.expand_dims(g, 2 * i + 1)
        g = jnp.broadcast_to(g, tgt)
    return jnp.pad(g.reshape(n), (0, _pad_to(n) - n))


def build_gmg(
    a: DIAMatrix,
    shape: Sequence[int],
    params=None,
    plan_power: int = 2,
    omega: float = 0.7,
    fsai_smoother: bool = False,
    min_side: int = 8,
    omega_fsai: float = 1.0,
    fsai_levels: int = 1 << 30,
) -> GMGPreconditioner:
    """Device-side GMG setup from the fine DIA operator.

    ``fsai_smoother`` replaces damped Jacobi with the structured-FSAI
    factor S = C C^T (classical if ``params`` is None, the trained
    NeuralFSAI head otherwise — width-local, so one checkpoint smooths
    every level) on the first ``fsai_levels`` levels; deeper levels
    keep damped Jacobi.  ``fsai_levels=1`` smooths only the finest
    level — most of the FSAI smoother's iteration win at a fraction of
    its setup and cycle cost (the coarse-level error components it
    would polish are exactly the ones the recursion handles).
    Coarsening stops when a side would drop below ``min_side`` or go
    odd; the root is densely inverted ON DEVICE (f32, symmetrized) so
    the whole build is ONE compiled dispatch — the eager form cost
    ~150 ms at 64^3 in per-op dispatch overhead alone.
    """
    shape = tuple(int(s) for s in shape)
    lvl_shapes = []
    s = shape
    while all(d % 2 == 0 and d >= 2 * min_side for d in s):
        lvl_shapes.append(s)
        s = tuple(d // 2 for d in s)
    return _build_gmg_jit(
        a, params, tuple(lvl_shapes), s, plan_power, omega,
        fsai_smoother, omega_fsai, fsai_levels,
    )


def _dia_to_dense_static(a: DIAMatrix) -> jax.Array:
    """(n, n) dense from DIA via static jnp.diag placements (jittable —
    ``DIAMatrix.to_dense``'s boolean masking is not)."""
    nc = a.n
    out = jnp.zeros((nc, nc), a.vals.dtype)
    for d_i, off in enumerate(a.offsets):
        if off >= 0:
            band = a.vals[d_i, : nc - off]
        else:
            band = a.vals[d_i, -off:nc]
        out = out + jnp.diag(band, k=off)
    return out


@functools.partial(
    jax.jit,
    static_argnames=(
        "lvl_shapes", "root_shape", "plan_power", "omega",
        "fsai_smoother", "omega_fsai", "fsai_levels",
    ),
)
def _build_gmg_jit(
    a: DIAMatrix,
    params,
    lvl_shapes,
    root_shape,
    plan_power: int,
    omega: float,
    fsai_smoother: bool,
    omega_fsai: float,
    fsai_levels: int,
) -> GMGPreconditioner:
    from deeppreconditioning_tpu.ops.structured_fsai import (
        bands_to_dia,
        build_structured_plan,
        structured_setup,
    )

    levels = []
    lvl_a = a
    for lvl_idx, lvl_shape in enumerate(lvl_shapes):
        diag_idx = lvl_a.offsets.index(0)
        d = lvl_a.vals[diag_idx]
        inv_d = jnp.where(d == 0, 0.0,
                          1.0 / jnp.where(d == 0, 1.0, d))
        c_up = c_low = None
        if fsai_smoother and lvl_idx < fsai_levels:
            plan = build_structured_plan(lvl_shape, power=plan_power)
            bands, _ = structured_setup(lvl_a, plan, params)
            if omega_fsai != 1.0:
                bands = bands * jnp.sqrt(
                    jnp.asarray(omega_fsai, bands.dtype)
                )
            c_up, c_low = bands_to_dia(bands, plan.offsets, lvl_a.n)
            # smoother spectral safeguard: the smoothing iteration's
            # error operator is I - S A, stable iff lam_max(S A) < 2.
            # A head trained at lower coefficient contrast can
            # overshoot out-of-distribution (sigma=2 at 128^3 ran the
            # V-cycle to 1024 PCG iterations without converging);
            # power-iterate lam_max(S A) and scale S down to
            # 2 - margin when it exceeds that — a no-op in
            # distribution, a cure OOD.  Same contract philosophy as
            # structured_fsai.poly_safeguard.
            v = jnp.cos(
                jnp.arange(lvl_a.n_pad, dtype=lvl_a.vals.dtype) * 0.7
            ) * (jnp.arange(lvl_a.n_pad) < lvl_a.n)
            lam = jnp.asarray(0.0, lvl_a.vals.dtype)
            for _ in range(8):
                w_ = c_low.matvec(c_up.matvec(lvl_a.matvec(v)))
                lam = jnp.linalg.norm(w_) / jnp.maximum(
                    jnp.linalg.norm(v), 1e-30)
                v = w_ / jnp.maximum(jnp.linalg.norm(w_), 1e-30)
            scale = jnp.minimum(1.0, 1.9 / jnp.maximum(lam, 1e-30))
            c_up = c_up.replace(
                vals=c_up.vals * jnp.sqrt(scale))
            c_low = c_low.replace(
                vals=c_low.vals * jnp.sqrt(scale))
        levels.append(GMGLevel(
            a=lvl_a, inv_diag=inv_d, c_up=c_up, c_low=c_low,
            shape=lvl_shape, omega=omega,
        ))
        lvl_a = galerkin_coarse_dia(lvl_a, lvl_shape)

    inv = jnp.linalg.inv(_dia_to_dense_static(lvl_a))
    return GMGPreconditioner(
        levels=tuple(levels),
        coarse_inv=0.5 * (inv + inv.T),
        coarse_shape=root_shape,
    )


def _smooth(lev: GMGLevel, r: jax.Array) -> jax.Array:
    if lev.c_up is None:
        return lev.omega * lev.inv_diag * r
    return lev.c_low.matvec(lev.c_up.matvec(r))


def gmg_apply(m: GMGPreconditioner, r: jax.Array) -> jax.Array:
    """One symmetric V(1,1)-cycle: z ~= A^-1 r (PCG apply).

    Unrolled at trace time over the static level tuple; every operator
    application is a DIA band sweep, every transfer a reshape.
    """

    def cycle(lvl: int, r: jax.Array) -> jax.Array:
        if lvl == len(m.levels):
            nc = m.coarse_inv.shape[0]
            z = jnp.matmul(m.coarse_inv, r[:nc],
                           precision=jax.lax.Precision.HIGHEST)
            return jnp.pad(z, (0, r.shape[0] - nc))
        lev = m.levels[lvl]
        x = _smooth(lev, r)
        res = r - lev.a.matvec(x)
        xc = cycle(lvl + 1, restrict_pc(res, lev.shape))
        x = x + prolong_pc(xc, lev.shape)
        return x + _smooth(lev, r - lev.a.matvec(x))

    return cycle(0, r)
