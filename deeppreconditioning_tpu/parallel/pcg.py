"""Distributed PCG: row-partitioned SpMV + psum scalars under shard_map.

The distributed numeric contract matches the single-device solver
(solvers/cg.py, itself matching reference cg.py:50-90) bit-for-bit modulo
floating-point reduction order: same update sequence, same squared
relative-residual stopping rule, same iteration cap.  Every dot product
becomes a local partial dot + ``jax.lax.psum`` over the mesh axis
(SURVEY.md §2.4 item 3); the SpMV comes in two exchange flavors:

  * ``allgather`` — gather the full x each application.  Exact for any
    sparsity pattern; right for small n or unstructured patterns.
  * ``halo`` — exchange fixed-width boundary slabs with ring neighbors
    via ``ppermute`` (SURVEY.md §2.4 item 2).  Exact when the matrix
    bandwidth <= halo width (FVM/Poisson row orderings); communication
    is O(halo) instead of O(n).

Preconditioner applies are shard-local (diagonal / block-Jacobi), so
z = M r needs no communication (SURVEY.md §2.4 item 4).
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from jax import shard_map as _shard_map

from deeppreconditioning_tpu.parallel.partition import ShardedELL
from deeppreconditioning_tpu.solvers.cg import CGResult


def identity_local(m_data, r):
    del m_data
    return r


def diag_local(m_data, r):
    """Shard-local Jacobi apply: m_data is the local slice of 1/diag."""
    return m_data * r


def sharded_matvec(cols, vals, x_local, axis_name, mode, halo, n_total):
    """Local rows of y = A x, communicating x as needed (shard-local
    view; call inside shard_map)."""
    if mode == "halo":
        return _matvec_halo(cols, vals, x_local, axis_name, halo, n_total)
    return _matvec_allgather(cols, vals, x_local, axis_name)


def _matvec_allgather(cols, vals, x_local, axis_name):
    x_full = jax.lax.all_gather(x_local, axis_name, tiled=True)
    x_ext = jnp.concatenate([x_full, jnp.zeros((1,), x_full.dtype)])
    return jnp.sum(vals * x_ext[cols], axis=1)


def _matvec_halo(cols, vals, x_local, axis_name, halo, n_total):
    """Single-neighbor halo exchange (exact iff bandwidth <= halo),
    overlapped with the interior SpMV.

    Each shard receives the last `halo` entries of its left neighbor and
    the first `halo` entries of its right neighbor via ``ppermute``.
    The accumulation is split into an *interior* pass that reads only
    ``x_local`` and a *boundary* pass that reads only the halo slabs:
    the interior gather-FMA has no data dependence on the collectives,
    so XLA's latency-hiding scheduler computes it while the
    transfers are in flight (SURVEY §2.4 item 2's mandated overlap).
    Cost: the (cols, vals) operands are streamed twice; interior work —
    the bulk at FVM bandwidths — hides the communication latency.

    Ring wrap-around slabs are never addressed: edge shards have no
    out-of-domain columns.
    """
    r = x_local.shape[0]
    axis_size = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    right_perm = [(i, (i + 1) % axis_size) for i in range(axis_size)]
    left_perm = [(i, (i - 1) % axis_size) for i in range(axis_size)]
    from_left = jax.lax.ppermute(x_local[-halo:], axis_name, right_perm)
    from_right = jax.lax.ppermute(x_local[:halo], axis_name, left_perm)

    rel = cols - idx * r  # column position relative to the shard start
    is_pad = cols >= n_total

    # interior pass: columns inside [0, r) — independent of the halos
    interior = (rel >= 0) & (rel < r) & ~is_pad
    loc = jnp.where(interior, rel, r)
    x_loc_ext = jnp.concatenate(
        [x_local, jnp.zeros((1,), x_local.dtype)]
    )
    y = jnp.sum(vals * x_loc_ext[loc], axis=1)

    # boundary pass: columns in the left/right halo slabs
    halos = jnp.concatenate(
        [from_left, from_right, jnp.zeros((1,), x_local.dtype)]
    )
    hidx = jnp.where(
        (rel < 0) & ~is_pad, rel + halo,
        jnp.where((rel >= r) & ~is_pad, rel - r + halo, 2 * halo),
    )
    hidx = jnp.clip(hidx, 0, 2 * halo)
    return y + jnp.sum(vals * halos[hidx], axis=1)


@partial(
    jax.jit,
    static_argnames=(
        "mesh", "axis_name", "mode", "apply_m", "max_iter",
        "n_shards", "halo", "n_total", "check_every",
    ),
)
def _pcg_sharded_impl(
    mesh, cols, vals, b, m_arg, apply_m, axis_name, mode,
    rtol, max_iter, n_shards, halo, n_total, check_every,
):
    def solve_local(cols, vals, b, m_local):
        def matvec(x):
            return sharded_matvec(
                cols, vals, x, axis_name, mode, max(halo, 1), n_total
            )

        def pdot(u, v):
            return jax.lax.psum(
                jnp.dot(u, v, precision=jax.lax.Precision.HIGHEST),
                axis_name)

        x = jnp.zeros_like(b)
        r = b - matvec(x)
        z = apply_m(m_local, r)
        p = z
        bb = pdot(b, b)
        bb = jnp.where(bb == 0, 1.0, bb)

        # chunked loop (see solvers/cg.py): fixed-trip masked iterations
        # inside, data-dependent convergence check only per chunk — the
        # check is a cross-host sync point on a real pod, so checking
        # every iteration would serialize the mesh on host round trips.
        def masked_iter(state):
            x, r, z, p, k, done = state
            frozen = jnp.logical_or(done, k >= max_iter)
            ap = matvec(p)
            rz = pdot(r, z)
            denom = pdot(ap, p)
            alpha = jnp.where(frozen, 0.0, rz / denom)
            x = x + alpha * p
            r_new = jnp.where(frozen, r, r - alpha * ap)
            z_new = jnp.where(frozen, z, apply_m(m_local, r_new))
            beta = jnp.where(frozen, 0.0, pdot(r_new, z_new) / rz)
            p = jnp.where(frozen, p, z_new + beta * p)
            k = jnp.where(frozen, k, k + 1)
            done = jnp.logical_or(done, pdot(r_new, r_new) / bb < rtol)
            return (x, r_new, z_new, p, k, done)

        def chunk(state):
            return jax.lax.fori_loop(
                0, check_every, lambda i, s: masked_iter(s), state
            )

        def cond(state):
            *_, k, done = state
            return jnp.logical_and(jnp.logical_not(done), k < max_iter)

        init_done = pdot(r, r) / bb < rtol
        x, r, z, p, k, done = jax.lax.while_loop(
            cond, chunk, (x, r, z, p, jnp.int32(0), init_done)
        )
        return x, k, pdot(r, r) / bb

    mapped = _shard_map(
        solve_local,
        mesh=mesh,
        in_specs=(P(axis_name), P(axis_name), P(axis_name), P(axis_name)),
        out_specs=(P(axis_name), P(), P()),
        check_vma=False,
    )
    return mapped(cols, vals, b, m_arg)


def pcg_sharded(
    mesh: Mesh,
    a: ShardedELL,
    b: jax.Array,  # (n_total,) global vector (sharded or replicated)
    m_data: Any = None,
    apply_m: Callable = identity_local,
    axis_name: str = "x",
    mode: str = "allgather",
    rtol: float = 1e-8,
    max_iter: int = 1024,
    check_every: int = 64,
) -> CGResult:
    """Distributed PCG over a 1-D mesh axis.

    ``apply_m(m_local, r_local)`` must be shard-local; ``m_data`` is a
    (n_total,)-shaped pytree sharded like b (e.g. inverse diagonal for
    Jacobi, or block tri-schedules for block-Jacobi IC).
    """
    if mode == "halo":
        assert a.halo <= a.rows_per_shard, (
            f"bandwidth {a.halo} exceeds shard rows "
            f"{a.rows_per_shard}; use mode='allgather'"
        )
    m_arg = (
        m_data if m_data is not None
        else jnp.zeros((a.n_total,), b.dtype)
    )
    x, k, res = _pcg_sharded_impl(
        mesh, a.cols, a.vals, b, m_arg, apply_m, axis_name, mode,
        rtol, max_iter, a.n_shards, a.halo, a.n_total, check_every,
    )
    return CGResult(x=x, iterations=k, residual=res)


def make_mesh(n_devices: int | None = None, axis_name: str = "x") -> Mesh:
    """A 1-D mesh over the first n_devices jax devices."""
    devs = np.array(jax.devices()[: n_devices or len(jax.devices())])
    return Mesh(devs, (axis_name,))
