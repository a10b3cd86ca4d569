"""Profiling + roofline utilities.

The reference's only instrumentation is wall-clock spans around its
loops (SURVEY.md §5: cg.py:69,88; test.py:130-135).  This module adds
``jax.profiler`` trace capture, chained-rep timing helpers, and roofline
accounting for the sparse kernels (nnz/s + bytes-moved estimates against
the device's HBM bandwidth, from a data-sheet table keyed by
``device_kind``).
"""

from __future__ import annotations

import contextlib
import itertools
import time
from dataclasses import dataclass
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp

# Data-sheet HBM bandwidth (GB/s) per ``jax.Device.device_kind``
# (NVIDIA H100 / H200 data sheets).  A device that is not listed has no
# assumed peak: ``hbm_peak_gb_s`` raises.
HBM_PEAK_GB_S = {
    "NVIDIA H100 80GB HBM3": 3350.0,  # H100 SXM5
    "NVIDIA H100 SXM5 80GB": 3350.0,
    "NVIDIA H100 PCIe": 2000.0,
    "NVIDIA H100 NVL": 3900.0,
    "NVIDIA H200": 4800.0,
}


def hbm_peak_gb_s(device_kind: str | None = None) -> float:
    """Data-sheet HBM bandwidth of ``device_kind`` (default: the first
    device's).  Raises KeyError for a device not in HBM_PEAK_GB_S."""
    if device_kind is None:
        device_kind = jax.devices()[0].device_kind
    try:
        return HBM_PEAK_GB_S[device_kind]
    except KeyError:
        raise KeyError(
            f"no HBM peak known for device kind {device_kind!r}; add it "
            "to utils/profiling.HBM_PEAK_GB_S from its data sheet"
        ) from None


# process-global uniqueness source for timing-rep inputs: every rep of a
# chain carries distinct input values, so no rep can be folded into
# another
_UNIQUE = itertools.count(1)


def next_unique() -> int:
    """A process-unique small integer for jitter construction."""
    return next(_UNIQUE)


def sync(tree):
    """Wait until every array of ``tree`` is computed
    (``jax.block_until_ready``); returns ``tree``."""
    return jax.block_until_ready(tree)


def _tie(x, carry):
    """Multiply float leaves by (1 + 0*carry): value-inert, but forces
    a data dependence on the previous rep so the runtime can neither
    skip, dedupe, nor reorder any rep."""
    def one(v):
        if hasattr(v, "dtype") and jnp.issubdtype(v.dtype, jnp.floating):
            return v * (1 + 0 * carry).astype(v.dtype)
        return v
    return jax.tree.map(one, x)


def time_chain(fn, operands, make_input, reps=(3, 12),
               blocks: int = 2) -> float:
    """Amortized per-rep seconds of ``fn(operands, x)``:

      * all reps run INSIDE one compiled dispatch (``lax.scan``), each
        rep's input distinct (``make_input(i)`` must return a
        fresh-valued pytree every call, e.g. scaled by
        ``1 + next_unique()*1.2e-7``) and tied to the previous rep's
        output, so no rep can be skipped or reordered;
      * two rep counts are run and the constant overhead (sync +
        dispatch) is removed by the two-point slope
        T = (t2 - t1) / (r2 - r1); each point is best-of-``blocks``.

    ``operands`` is a device pytree passed as a jit argument (not a
    closure constant, which XLA would embed in the executable).  ``fn``
    must be traceable: fn(operands, x) -> pytree.
    """
    r1, r2 = reps

    @partial(jax.jit, static_argnames=("r",))
    def run(operands, stack, r):
        def body(carry, x):
            out = fn(operands, _tie(x, carry))
            leaf = next(
                v for v in jax.tree.leaves(out)
                if hasattr(v, "dtype")
                and jnp.issubdtype(v.dtype, jnp.floating)
            )
            raw = jnp.ravel(leaf)[0].astype(jnp.float32)
            return jnp.where(jnp.isfinite(raw), raw, 1.0), None
        carry, _ = jax.lax.scan(body, jnp.float32(0), stack, length=r)
        return carry

    def stack_inputs(r):
        xs = [make_input(i) for i in range(r)]
        return jax.tree.map(lambda *vs: jnp.stack(vs), *xs)

    # warm both executables (compile) + one throwaway timed shape
    for r in (r1, r2):
        sync(run(operands, stack_inputs(r), r))
    ts = {r1: [], r2: []}
    for _ in range(blocks):
        for r in (r1, r2):
            stack = stack_inputs(r)
            sync(stack)
            t0 = time.perf_counter()
            sync(run(operands, stack, r))
            ts[r].append(time.perf_counter() - t0)
    return (min(ts[r2]) - min(ts[r1])) / (r2 - r1)


@contextlib.contextmanager
def trace(log_dir: str | Path = "assets/results/trace"):
    """Capture a jax.profiler trace viewable in tensorboard/xprof."""
    jax.profiler.start_trace(str(log_dir))
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@dataclass
class RooflineReport:
    """Measured vs light-speed throughput for a streaming sparse kernel."""

    name: str
    seconds: float
    nnz: int
    bytes_moved: int
    flops: int
    hbm_gb_s: float | None = None  # None: the device's data-sheet
    # peak (hbm_peak_gb_s)

    def __post_init__(self):
        if self.hbm_gb_s is None:
            self.hbm_gb_s = hbm_peak_gb_s()

    @property
    def gnnz_per_s(self) -> float:
        return self.nnz / self.seconds / 1e9

    @property
    def achieved_gb_s(self) -> float:
        return self.bytes_moved / self.seconds / 1e9

    @property
    def bandwidth_fraction(self) -> float:
        return self.achieved_gb_s / self.hbm_gb_s

    def summary(self) -> dict:
        return {
            "kernel": self.name,
            "time_us": round(self.seconds * 1e6, 1),
            "gnnz_per_s": round(self.gnnz_per_s, 2),
            "achieved_gb_s": round(self.achieved_gb_s, 1),
            "bandwidth_fraction": round(self.bandwidth_fraction, 3),
            "gflop_per_s": round(self.flops / self.seconds / 1e9, 1),
        }


def time_dispatch_chain(step, reps=(3, 12), blocks: int = 2) -> float:
    """Two-point amortized per-rep seconds for a chain of DISPATCHES.

    ``step(i, tie)`` must issue one dispatch whose input values fold in
    ``tie`` (a traced f32 scalar from the previous rep, e.g.
    ``x * (1 + next_unique()*1.2e-7 + 0*tie)``) — the device-level
    dependence orders the reps and the unique jitter keeps them
    distinct.  Equivalent to ``time_chain`` without requiring the
    computation to be traceable into one scan; use this form when the
    build mixes host work or closes over large device arrays.
    """
    r1, r2 = reps

    def run(r):
        tie = jnp.float32(0)
        out = None
        t0 = time.perf_counter()
        for i in range(r):
            out = step(i, tie)
            leaf = next(
                v for v in jax.tree.leaves(out)
                if hasattr(v, "dtype")
                and jnp.issubdtype(v.dtype, jnp.floating)
            )
            tie = jnp.ravel(leaf)[0].astype(jnp.float32)
        sync(out)
        return time.perf_counter() - t0

    run(1)  # warm (compile incl. the tie slice)
    ts = {r1: [], r2: []}
    for _ in range(blocks):
        for r in (r1, r2):
            ts[r].append(run(r))
    return (min(ts[r2]) - min(ts[r1])) / (r2 - r1)


def time_cold_stream(apply_fn, big_operand, x0, min_pool_bytes=2.0e8,
                     reps_budget_s=6e-3):
    """Per-call seconds of ``apply_fn(big_operand_i, x)`` with the
    large operand COLD in HBM on every call.

    A scan-chained repeat of one operator measures the cache-resident
    rate once the operand fits in on-chip memory (the H100's L2 holds
    50 MB).  For the streaming roofline this helper cycles a pool of
    jittered operand copies sized past ``min_pool_bytes`` so every rep's
    operand must come from HBM, and scales the rep count so the
    measured span clears the scan-slope noise floor.

    ``apply_fn(operand_leaf, x) -> array`` where ``operand_leaf`` is
    one pool entry (same shape as ``big_operand``).  Returns seconds
    per single apply.

    Implementation notes: an operand already larger than on-chip
    memory needs no pool — the plain chain is cold.  Smaller operands
    cycle pool entries via ``lax.switch`` over per-copy branches; a
    stacked-array ``dynamic_index_in_dim`` would MATERIALIZE a copy of
    the selected operand every rep and time memcpy (~300 GB/s flat
    across grids), not the kernel.
    """
    nbytes = big_operand.size * big_operand.dtype.itemsize
    est = max(nbytes / (hbm_peak_gb_s() * 1e9), 1e-6)
    r2 = int(min(max(reps_budget_s / est, 16), 256))
    r1 = max(r2 // 4, 2)

    if nbytes >= min_pool_bytes:
        return time_chain(
            apply_fn, big_operand,
            lambda i: x0 * (1.0 + next_unique() * jnp.float32(1.2e-7)),
            reps=(r1, r2),
        )

    pool_n = int(-(-min_pool_bytes // nbytes))
    pool = tuple(
        big_operand * (1.0 + next_unique() * 1.2e-7)
        for _ in range(pool_n)
    )

    def fn(pool_, inp):
        x, sel = inp["x"], inp["sel"]
        return jax.lax.switch(
            sel,
            [partial(apply_fn, leaf) for leaf in pool_],
            x,
        )

    def make_input(i):
        return {
            "x": x0 * (1.0 + next_unique() * jnp.float32(1.2e-7)),
            "sel": jnp.int32(i % pool_n),
        }

    return time_chain(fn, pool, make_input, reps=(r1, r2))
