"""Structured-grid FSAI — the learned preconditioner at 128^3+ scale.

The generic FSAI machinery (ops/fsai.py) carries O(n w^2) index plans
and gather-based extraction — fine at benchmark sizes (n ~ 1k), hostile
at the BASELINE.md scaling sizes (128^3 = 2M rows: a (n, w, w) int32
sub_idx plan alone is 1.4 GB).  On a *structured* grid none of that
indexing is needed: every column's FSAI pattern is the same set of
linear offsets (the tril of the stencil-graph power), so

  * the pattern is a static tuple of offsets with known displacement
    vectors — no per-column index arrays at all;
  * submatrix extraction A~[S_j, S_j] is, per (p, q) slot pair, a
    statically shifted read of one DIA band (no gather);
  * the factor C is stored directly in offset-band form
    bands[k, j] = C[j + o_k, j] and both halves of the apply are
    shift-multiply-add over static offsets (the DIA SpMV idiom,
    sparse/dia.py) — speed-of-light HBM-bound ops;
  * boundary pruning is a coordinate mask computed from iota on device
    (grid points whose displaced neighbor would leave the box), exactly
    equivalent to the graph-power pattern's boundary truncation.

The per-column refinement MLP + polynomial wrap of the NeuralFSAI
flagship (models/neural_fsai.py) are width-local, so a checkpoint
trained on small systems applies unchanged at any n — this module is
how that checkpoint deploys at 64^3/128^3 on the real chip (VERDICT r3
next #3).  ``structured_refine`` reproduces the NeuralFSAI model's math
bit-for-bit from the raw param dict (parity-tested against
``NeuralFSAI.apply`` in tests/test_structured_fsai.py).

Reference parity: same Kaporin local-solve semantics as ops/fsai.py;
the deployed apply equals the reference's dense z = M r convention
(uibk/deep_preconditioning/cg.py:81) in factor form.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from deeppreconditioning_tpu.models.neural_fsai import _dense
from deeppreconditioning_tpu.ops import gauss_jordan
from deeppreconditioning_tpu.sparse.dia import DIAMatrix


class StructuredFSAIPlan:
    """Static (host-built) pattern description — no device arrays.

    A pattern slot is one *unique nonnegative linear offset* of the
    stencil-graph power.  Distinct displacement vectors can alias the
    same linear offset on small grids (e.g. [0,0,2] and [0,1,-1] when
    nx = 3) — they are one graph entry C[j+o, j], live wherever ANY
    vector of the class stays inside the box.

    Attributes:
        shape: grid shape (tuple of ints).
        offsets: (w,) unique linear offsets, ascending, offsets[0] = 0.
        disp_classes: per slot, the (m_k, ndim) displacement vectors
            sharing that linear offset (validity is their OR).
        a_offsets: linear offsets of the operator's DIA bands (must
            match the DIA band order; unique by construction).
        delta_idx: (w, w) int — delta_idx[p, q] = DIA band index d with
            A[j + o_p, j + o_q] = vals[d, j + o_p], or -1 when
            (o_q - o_p) is not an operator offset.  Boundary truncation
            needs no extra mask here: the DIA generators store 0 where
            a band's step would leave the grid.
    """

    def __init__(self, shape, disp, a_offsets):
        self.shape = tuple(int(s) for s in shape)
        disp = np.asarray(disp, np.int64)
        strides = _strides(self.shape)
        lin = disp @ strides
        offs = np.unique(lin[lin >= 0])
        assert offs[0] == 0, "pattern must contain the diagonal"
        self.offsets = tuple(int(o) for o in offs)
        self.disp_classes = [
            disp[lin == o] for o in self.offsets
        ]
        self.a_offsets = tuple(int(o) for o in a_offsets)
        assert len(set(self.a_offsets)) == len(self.a_offsets)
        w = len(self.offsets)
        self.delta_idx = np.full((w, w), -1, np.int64)
        for p in range(w):
            for q in range(w):
                delta = self.offsets[q] - self.offsets[p]
                if delta in self.a_offsets:
                    self.delta_idx[p, q] = self.a_offsets.index(delta)

    @property
    def width(self) -> int:
        return len(self.offsets)

    # content-based identity: plans are jit static args
    # (structured_fsai_columns etc.) — the default identity hash made
    # every freshly built plan a new cache key, recompiling the column
    # solver on each setup (observed as a 4.7 s GMG build whose reps
    # were all compiles)
    def _key(self):
        return (
            self.shape, self.offsets, self.a_offsets,
            tuple(c.tobytes() for c in self.disp_classes),
        )

    def __eq__(self, other):
        return (
            isinstance(other, StructuredFSAIPlan)
            and self._key() == other._key()
        )

    def __hash__(self):
        return hash((self.shape, self.offsets, self.a_offsets))


def _strides(shape: Sequence[int]) -> np.ndarray:
    nd = len(shape)
    return np.array(
        [int(np.prod(shape[i + 1:])) for i in range(nd)], np.int64
    )


def stencil_displacements(ndim: int) -> np.ndarray:
    """Displacement vectors of the standard 2*ndim+1-point stencil, in
    the order of poisson_dia's offsets (ascending linear offset)."""
    disp = [np.zeros(ndim, np.int64)]
    for ax in range(ndim):
        for sgn in (-1, 1):
            d = np.zeros(ndim, np.int64)
            d[ax] = sgn
            disp.append(d)
    disp = np.stack(disp)
    return disp


def build_structured_plan(
    shape: Sequence[int], power: int = 2
) -> StructuredFSAIPlan:
    """Pattern = tril of the stencil-graph ``power`` (all displacement
    sums of <= power stencil steps with nonnegative linear offset) —
    the structured twin of ops/fsai.tril_power_pattern.  Cached per
    (shape, power): callers build plans freely (e.g. per GMG level per
    setup) without re-running the host set expansion."""
    return _build_structured_plan_cached(
        tuple(int(s) for s in shape), int(power)
    )


@functools.lru_cache(maxsize=None)
def _build_structured_plan_cached(
    shape: Tuple[int, ...], power: int
) -> StructuredFSAIPlan:
    ndim = len(shape)
    steps = stencil_displacements(ndim)
    reach = {tuple(np.zeros(ndim, np.int64))}
    frontier = set(reach)
    for _ in range(power):
        nxt = set()
        for f in frontier:
            for s in steps:
                nxt.add(tuple(np.asarray(f) + s))
        frontier = nxt - reach
        reach |= nxt
    strides = _strides(shape)
    disp = np.array(sorted(reach), np.int64).reshape(-1, ndim)
    a_offsets = tuple(sorted(
        int(d @ strides) for d in stencil_displacements(ndim)
    ))
    return StructuredFSAIPlan(shape, disp, a_offsets)


def dia_sorted_by_offset(a: DIAMatrix) -> DIAMatrix:
    """DIA with bands sorted by offset (the plan's a_disp order)."""
    order = np.argsort(a.offsets, kind="stable")
    if list(order) == list(range(len(a.offsets))):
        return a
    return DIAMatrix(
        vals=a.vals[jnp.asarray(order)],
        offsets=tuple(a.offsets[i] for i in order),
        n=a.n,
    )


def _coords(shape, n_pad):
    """Per-linear-index grid coordinates via iota (device, no host
    arrays at n ~ 2M) — standard mixed-radix peel."""
    coords = []
    rem = jnp.arange(n_pad)
    for s in _strides(shape):
        coords.append(rem // int(s))
        rem = rem - coords[-1] * int(s)
    return coords  # list of (n_pad,) int arrays (unclamped beyond n)


def slot_valid(plan: StructuredFSAIPlan, n_pad: int) -> jax.Array:
    """(n_pad, w) float mask: slot k live at column j iff ANY
    displacement vector of its linear-offset class stays inside the box
    (and j < n)."""
    shape = plan.shape
    n = int(np.prod(shape))
    coords = _coords(shape, n_pad)
    live = jnp.arange(n_pad) < n
    masks = []
    for k in range(plan.width):
        any_ok = jnp.zeros(n_pad, bool)
        for d_vec in plan.disp_classes[k]:
            ok = live
            for ax in range(len(shape)):
                d = int(d_vec[ax])
                c = coords[ax]
                ok = ok & (c + d >= 0) & (c + d < shape[ax])
            any_ok = any_ok | ok
        masks.append(any_ok)
    return jnp.stack(masks, axis=1).astype(jnp.float32)


@functools.partial(jax.jit, static_argnames=("plan", "chunk"))
def structured_fsai_columns(
    a_scaled: DIAMatrix,
    plan: StructuredFSAIPlan,
    chunk: int = 1 << 18,
) -> jax.Array:
    """FSAI column values on the scaled operator, offset-band layout.

    Returns bands (w, n_pad): bands[k, j] = C~[j + offsets[k], j].
    Semantics identical to ops/fsai.fsai_values on the equivalent
    graph-power pattern (normal-equations local solve, unit target,
    1/sqrt(y_pos) normalization); extraction and storage are
    shift-structured instead of index-planned.
    """
    n_pad = a_scaled.n_pad
    w = plan.width
    dtype = a_scaled.vals.dtype
    valid = slot_valid(plan, n_pad).astype(dtype)  # (n_pad, w)
    halo = max(plan.offsets[-1], a_scaled.halo)
    vals_ext = jnp.pad(a_scaled.vals, ((0, 0), (0, 2 * halo)))

    if n_pad % chunk != 0:
        chunk = n_pad  # single chunk fallback (small grids)

    def body(lo):
        vt = jax.lax.dynamic_slice(
            valid, (lo, 0), (chunk, w)
        ).T  # (w, T)
        # assemble the augmented system directly in the lane-major
        # (w, w+1, T) layout ops/gauss_jordan.py consumes — the masked
        # shifted band reads land as (w, w, T) stacks, the unit rhs is
        # one extra column, and the output (w, T) is already the
        # offset-band factor layout: zero transposes
        zeros = jnp.zeros((chunk,), dtype)
        rows = []
        for p in range(w):
            row = []
            for q in range(w):
                d = int(plan.delta_idx[p, q])
                if d < 0:
                    row.append(zeros)
                    continue
                band = jax.lax.dynamic_slice(
                    vals_ext[d], (lo + plan.offsets[p],), (chunk,)
                )
                row.append(band * vt[p] * vt[q])
            rows.append(jnp.stack(row))
        sub = jnp.stack(rows)  # (w, w, T), sub[p, q] = A~[j+op, j+oq]
        pad = 1.0 - vt  # (w, T)
        sub = sub + jnp.eye(w, dtype=dtype)[:, :, None] * pad[:, None, :]
        e = (jnp.arange(w) == 0).astype(dtype)[:, None, None]
        aug = jnp.concatenate(
            [sub, jnp.broadcast_to(e, (w, 1, chunk))], axis=1
        )  # (w, w+1, T)
        y = gauss_jordan.gauss_jordan_lanes(aug)  # (w, T)
        c = y * jax.lax.rsqrt(jnp.maximum(y[0], 1e-30))[None, :]
        return c * vt  # (w, T)

    # lax.map traces the chunk body once instead of inlining a copy per
    # chunk, which keeps the 128^3 program small
    starts = jnp.arange(0, n_pad, chunk)
    outs = jax.lax.map(body, starts)  # (n_chunks, w, T)
    return jnp.moveaxis(outs, 0, 1).reshape(w, n_pad)


def structured_a_col(
    a_scaled: DIAMatrix, plan: StructuredFSAIPlan
) -> jax.Array:
    """a_col[j, k] = A~[j + o_k, j] masked — the refinement MLP's local
    structure feature (models/neural_fsai.py feats)."""
    n_pad = a_scaled.n_pad
    dtype = a_scaled.vals.dtype
    valid = slot_valid(plan, n_pad).astype(dtype)
    halo = max(plan.offsets[-1], a_scaled.halo)
    vals_ext = jnp.pad(a_scaled.vals, ((0, 0), (0, 2 * halo)))
    cols = []
    for k in range(plan.width):
        d = int(plan.delta_idx[k, 0])  # A[j + o_k, j]
        if d < 0:
            cols.append(jnp.zeros(n_pad, dtype))
        else:
            band = jax.lax.dynamic_slice(
                vals_ext[d], (plan.offsets[k],), (n_pad,)
            )
            cols.append(band * valid[:, k] * valid[:, 0])
    return jnp.stack(cols, axis=1)  # (n_pad, w)


def structured_refine(
    params,
    c_bands: jax.Array,  # (w, n_pad) base column values
    a_col: jax.Array,  # (n_pad, w)
    valid: jax.Array,  # (n_pad, w)
    chunk: int = 1 << 18,
) -> Tuple[jax.Array, jax.Array]:
    """NeuralFSAI refinement head on offset-band columns.

    Replicates models/neural_fsai.NeuralFSAI.__call__'s MLP math
    (dense0 -> gelu -> dense1 -> gelu -> alpha/beta heads, zero-init
    residual refinement, identity-init polynomial) directly from the
    param dict.  Slot-layout caveat: the generic plans PACK each
    column's live pattern entries to the front, while this layout keys
    slots by fixed offset with dead slots in place — identical on
    interior columns (all slots live, ascending row order == ascending
    offset), different at boundary columns.  Checkpoints deployed here
    should therefore be trained through this structured path
    (scripts/train_structured.py), which makes train and deploy
    layouts identical by construction; parity with the NeuralFSAI model is
    asserted on interior columns in tests/test_structured_fsai.py.
    Returns (refined bands (w, n_pad), q_coeffs).
    """
    p = params["params"]
    c_full = c_bands.T  # (n_pad, w)
    n_pad, w = c_full.shape
    dtype = c_full.dtype

    def body(args):
        c, a_c, v = args
        pad = (1.0 - v).astype(dtype)
        pos1h = jnp.zeros((1, w), dtype).at[0, 0].set(1.0)
        c_diag = c[:, 0:1]
        denom = jnp.maximum(jnp.abs(c_diag), 1e-20)
        feats = jnp.concatenate(
            [c / denom, a_c.astype(dtype),
             jnp.broadcast_to(pos1h, c.shape), pad], axis=1
        )
        h = jax.nn.gelu(_dense(p["dense0"], feats))
        h = jax.nn.gelu(_dense(p["dense1"], h))
        alpha = _dense(p["alpha"], h)
        beta = _dense(p["beta"], h)
        live = v.astype(dtype)
        refined = (c * jnp.exp(alpha)
                   + (1.0 - jnp.broadcast_to(pos1h, c.shape))
                   * beta * c_diag)
        return refined * live

    if n_pad % chunk == 0 and n_pad > chunk:
        # row-chunked via lax.map: one traced body for every chunk
        # keeps the 128^3 program small
        k = n_pad // chunk
        refined = jax.lax.map(body, (
            c_full.reshape(k, chunk, w),
            a_col.reshape(k, chunk, w),
            valid.reshape(k, chunk, w),
        )).reshape(n_pad, w)
    else:
        refined = body((c_full, a_col, valid))
    dq = p["q_coeffs"]
    q0 = jnp.zeros_like(dq).at[0].set(1.0)
    return refined.T, q0 + dq


def fold_scaling(
    bands: jax.Array,  # (w, n_pad) scaled-space factor
    d_isqrt: jax.Array,  # (n_pad,)
    offsets: Tuple[int, ...],
) -> jax.Array:
    """C_eff = D^-1/2 C~ (row scaling) in offset-band layout:
    bands_eff[k, j] = d_isqrt[j + o_k] * bands[k, j]."""
    n_pad = bands.shape[1]
    halo = max(offsets)
    d_ext = jnp.pad(d_isqrt, (0, halo))
    rows = [
        bands[k] * jax.lax.dynamic_slice(d_ext, (off,), (n_pad,))
        for k, off in enumerate(offsets)
    ]
    return jnp.stack(rows)


def offset_upper_matvec(bands, r, offsets: Tuple[int, ...]):
    """t = C^T r: t[j] = sum_k bands[k, j] r[j + o_k]."""
    n_pad = r.shape[-1]
    halo = max(offsets)
    r_ext = jnp.pad(r, (0, halo))
    t = jnp.zeros_like(r)
    for k, off in enumerate(offsets):
        t = t + bands[k] * jax.lax.dynamic_slice(
            r_ext, (off,), (n_pad,)
        )
    return t


def offset_lower_matvec(bands, t, offsets: Tuple[int, ...]):
    """z = C t: z[i] = sum_k bands[k, i - o_k] t[i - o_k].

    Per-band sliced products padded into place + an add tree: since
    both factors carry the SAME shift, each term reads only its own
    band slice and the matching t slice — no (w, n) product buffer and
    no full-array pad.  Measured 0.19 ms vs 2.3 ms for the
    ``.at[off:off+n].add`` accumulation chain and 1.6 ms for the
    padded-product-matrix form on 13 bands at 128^3 (bit-exact across
    all three)."""
    n_pad = t.shape[-1]
    lead = t.shape[:-1]
    terms = []
    for k, off in enumerate(offsets):
        prod = bands[..., k, :n_pad - off] * t[..., :n_pad - off]
        terms.append(jnp.pad(
            prod, [(0, 0)] * len(lead) + [(off, 0)]
        ))
    return functools.reduce(jnp.add, terms)


def bands_to_dia(
    bands: jax.Array,  # (w, n_pad) offset-band factor C
    offsets: Tuple[int, ...],
    n: int,
) -> Tuple[DIAMatrix, DIAMatrix]:
    """Offset-band factor -> (C^T, C) as DIAMatrix operators.

    ``offset_upper_matvec`` IS a DIA SpMV with positive offsets
    (t[j] = sum_k bands[k, j] r[j + o_k]), so C^T wraps the band array
    unchanged.  C's matvec (z[i] = sum_k bands[k, i - o_k] t[i - o_k])
    re-bases each band to row-major ONCE at setup
    (rb[k, i] = bands[k, i - o_k], a static pad per band) and becomes a
    DIA SpMV with the negated offsets.  Both halves then run as one
    fused ``DIAMatrix.matvec`` pass each instead of the ~w pad+add
    fusions of the offset form.
    """
    n_pad = bands.shape[1]
    rows = []
    for k, off in enumerate(offsets):
        if off == 0:
            rows.append(bands[k])
        else:
            rows.append(jnp.pad(bands[k, :n_pad - off], (off, 0)))
    rb = jnp.stack(rows)
    c_up = DIAMatrix(vals=bands, offsets=tuple(offsets), n=n)
    c_low = DIAMatrix(
        vals=rb, offsets=tuple(-o for o in offsets), n=n
    )
    return c_up, c_low


def make_structured_poly_apply_dia(degree: int):
    """DIA-operator twin of ``make_structured_poly_apply``.

    m_data = (c_up, c_low, q_coeffs, a_raw) with (c_up, c_low) from
    ``bands_to_dia``; every factor half and operator matvec is one
    ``DIAMatrix.matvec`` pass (parity-tested against the offset form)."""

    def apply_fn(m_data, r: jax.Array) -> jax.Array:
        c_up, c_low, q_coeffs, a_raw = m_data
        dtype = r.dtype

        def b_(t):
            return c_up.matvec(a_raw.matvec(c_low.matvec(t))).astype(dtype)

        def q_(t):
            u = q_coeffs[degree] * t
            for i in range(degree - 1, -1, -1):
                u = b_(u) + q_coeffs[i] * t
            return u

        return c_low.matvec(q_(q_(c_up.matvec(r))))

    return apply_fn


def make_structured_poly_apply(offsets: Tuple[int, ...], degree: int):
    """Suite-style apply factory: z = C q(B) q(B)^T C^T r with
    m_data = (bands_eff, q_coeffs, a_raw: DIAMatrix) — the structured
    twin of ops/banded_factor.make_banded_poly_apply."""

    def apply_fn(m_data, r: jax.Array) -> jax.Array:
        bands, q_coeffs, a_raw = m_data
        dtype = r.dtype

        def c_t(x):
            return offset_upper_matvec(bands, x, offsets).astype(dtype)

        def c_(t):
            return offset_lower_matvec(bands, t, offsets).astype(dtype)

        def b_(t):
            return c_t(a_raw.matvec(c_(t)))

        def q_(t):
            u = q_coeffs[degree] * t
            for i in range(degree - 1, -1, -1):
                u = b_(u) + q_coeffs[i] * t
            return u

        return c_(q_(q_(c_t(r))))

    return apply_fn


def poly_safeguard(
    bands: jax.Array,  # (w, n_pad) refined scaled-space factor C~
    q_coeffs: jax.Array,  # (d+1,)
    a_scaled: DIAMatrix,
    offsets: Tuple[int, ...],
    iters: int = 8,
    margin: float = 1.15,
    grid: int = 65,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Clamp an unsafe polynomial wrap back to q = I at setup time.

    The trained q is spectrum-specific: deployed on a system whose
    B = C~^T A~ C~ spectrum extends past the training family's
    (coefficient contrast sigma above the trained range), q can change
    sign inside [0, lambda_max(B)] — M = C q(B) q(B)^T C^T stays SPD
    but is near-singular at interior eigenvalues and PCG breaks down
    (the round-4 README's known limitation; VERDICT r4 next #2).  The
    reference contract is an SPD M ~= A^-1
    (uibk/deep_preconditioning/cg.py:81).

    A few power iterations estimate lambda_max(B) (B_raw == B_scaled
    exactly: the Jacobi scaling fold cancels inside B), then q is
    evaluated on a dense grid of [0, margin * lambda_max]; any
    nonpositive value triggers the fallback to q = I — classical
    structured FSAI, which is unconditionally safe.  Cost: ``iters``
    B-applies, microseconds next to the setup's local solves.

    Returns (q_safe, safe_flag (bool scalar), lambda_max estimate).
    """
    n_pad = bands.shape[1]
    dtype = bands.dtype
    # B-applies through the DIA views: one fused pass per factor half
    # instead of the offset form's pad+add chains
    c_up, c_low = bands_to_dia(bands, offsets, a_scaled.n)

    def b_(t):
        return c_up.matvec(a_scaled.matvec(c_low.matvec(t)))

    # deterministic, sign-rich start vector (no data dependence)
    v = jnp.sin(jnp.arange(n_pad, dtype=dtype) * 0.7) + 0.5

    def body(_, v):
        w = b_(v)
        return w / jnp.maximum(jnp.linalg.norm(w), 1e-30)

    v = jax.lax.fori_loop(0, iters, body, v)
    w = b_(v)
    lam_max = jnp.vdot(v, w) / jnp.maximum(jnp.vdot(v, v), 1e-30)
    ts = jnp.linspace(0.0, margin, grid).astype(dtype) * lam_max
    deg = q_coeffs.shape[0] - 1
    qv = jnp.full_like(ts, q_coeffs[deg])
    for i in range(deg - 1, -1, -1):  # Horner
        qv = qv * ts + q_coeffs[i]
    safe = jnp.min(qv) > 0.0
    ident = jnp.zeros_like(q_coeffs).at[0].set(1.0)
    return jnp.where(safe, q_coeffs, ident), safe, lam_max


def jacobi_scale_dia(a: DIAMatrix) -> Tuple[DIAMatrix, jax.Array]:
    """(A~, d_sqrt): symmetric Jacobi scaling in DIA form —
    A~[i, i+off] = A[i, i+off] / (d_sqrt[i] d_sqrt[i+off])."""
    diag_idx = a.offsets.index(0)
    d = a.vals[diag_idx]
    d_safe = jnp.where(d == 0, 1.0, d)
    d_isqrt = jnp.where(d == 0, 0.0, 1.0 / jnp.sqrt(d_safe))
    n_pad = a.n_pad
    halo = a.halo
    d_ext = jnp.pad(d_isqrt, (halo, halo))
    rows = []
    for k, off in enumerate(a.offsets):
        rows.append(
            a.vals[k] * d_isqrt * jax.lax.dynamic_slice(
                d_ext, (halo + off,), (n_pad,)
            )
        )
    return (
        DIAMatrix(vals=jnp.stack(rows), offsets=a.offsets, n=a.n),
        jnp.sqrt(d_safe) * (d != 0),
    )


def structured_setup(
    a_raw: DIAMatrix,
    plan: StructuredFSAIPlan,
    params=None,
    chunk: int = 1 << 18,
    safeguard: bool = True,
):
    """Full deployed setup: scale -> local solves -> (optional learned
    refinement + spectral safeguard) -> scaling fold.  Returns
    (bands_eff (w, n_pad), q_coeffs) ready for
    ``make_structured_poly_apply`` with the RAW operator's matvec.
    params=None gives classical FSAI (q = I).  ``safeguard`` clamps an
    out-of-distribution polynomial wrap back to q = I when any of its
    roots falls inside B's estimated spectral interval
    (``poly_safeguard``)."""
    a_sorted = dia_sorted_by_offset(a_raw)
    a_scaled, d_sqrt = jacobi_scale_dia(a_sorted)
    c_bands = structured_fsai_columns(a_scaled, plan, chunk=chunk)
    if params is None:
        q = jnp.ones((1,), c_bands.dtype)
    else:
        valid = slot_valid(plan, a_sorted.n_pad).astype(c_bands.dtype)
        a_col = structured_a_col(a_scaled, plan)
        c_bands, q = structured_refine(params, c_bands, a_col, valid)
        if safeguard and q.shape[0] > 1:
            q, _, _ = poly_safeguard(
                c_bands, q, a_scaled, plan.offsets
            )
    d_isqrt = jnp.where(d_sqrt == 0, 0.0, 1.0 / d_sqrt)
    bands_eff = fold_scaling(c_bands, d_isqrt, plan.offsets)
    return bands_eff, q
