"""Batched small SPD solves — the FSAI / NeuralFSAI setup's local solves.

Every FSAI column j solves one w x w system A~[S_j, S_j] y = e (w = 24
for the sludge split, 4 or 13 on the structured plans), so a setup is a
batch of N independent tiny systems.  They are solved lane-major:
``aug (w, w+1, N)`` holds entry (p, q) of every system as one contiguous
length-N vector, and ``gauss_jordan_lanes`` runs w masked elimination
steps over the whole block.  The structured-grid plans assemble their
systems in this layout directly; ``solve_batched`` takes the row-major
``(N, w, w)`` systems of the generic and range-blocked plans through it.

This plain XLA form is the one path on every device.  On the H100 a
hand-written Triton kernel lost to it alone at every width and in both
structured setups, and won 4 % only in the batched learned setup, where
``jnp.linalg.solve`` (pivoted LU) was faster still but changes the
float32 results of every FSAI setup (PERF.md, "Kernel decisions").

No pivoting: the systems are principal blocks of a symmetrically
Jacobi-scaled SPD matrix with identity rows on dead slots, so every
pivot is positive (a zero pivot, from all-zero padding systems, is
guarded to 1).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def gauss_jordan_lanes(aug: jax.Array) -> jax.Array:
    """Solve the lane-major stack ``aug (w, w+1, N)`` -> (w, N): w masked
    whole-block steps (O(w) operations to compile, each one elementwise
    pass over the block)."""
    w = aug.shape[0]
    row_iota = jnp.arange(w)[:, None, None]
    for k in range(w):  # static k: the pivot row and column are slices
        pk = aug[k, k]
        row_k = aug[k] / jnp.where(pk == 0, 1.0, pk)  # (w+1, N)
        col_k = jnp.where(row_iota[:, :, 0] == k, 0.0, aug[:, k])  # (w, N)
        aug = jnp.where(row_iota == k, row_k[None],
                        aug - col_k[:, None] * row_k[None])
    return aug[:, w]


def to_lanes(sub: jax.Array, e: jax.Array) -> jax.Array:
    """(N, w, w) systems + (N, w) right-hand sides -> aug (w, w+1, N)."""
    return jnp.concatenate(
        [jnp.transpose(sub, (1, 2, 0)), jnp.transpose(e)[:, None, :]],
        axis=1,
    )


def solve_batched(sub: jax.Array, e: jax.Array) -> jax.Array:
    """Solve ``sub (N, w, w) @ y = e (N, w)`` -> y (N, w) through the
    lane-major layout."""
    return jnp.transpose(gauss_jordan_lanes(to_lanes(sub, e)))
