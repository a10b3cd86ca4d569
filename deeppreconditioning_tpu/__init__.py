"""Learned-preconditioner framework in JAX.

A from-scratch JAX/XLA/Pallas re-architecture of the capabilities of
jsappl/DeepPreconditioning: sparse SPD linear systems -> sparse-conv CNN
producing a lower-triangular factor L -> PCG with M = L @ L.T as
preconditioner, benchmarked against vanilla / Jacobi / IC(0).

Layer map (bottom-up):
    sparse/    static-shape sparse containers (batched COO, ELL, CSR, DIA)
    ops/       compute kernels: SpMV, sparse conv, tri-solve, IC(0), FSAI,
               multigrid (plain JAX; no hand-written kernel, PERF.md)
    solvers/   CG / PCG as lax.while_loop with on-device reductions
    models/    plain-JAX models (init/apply) over precomputed index plans
    data/      dataset generation (FVM pressure-Poisson, random SPD) + loaders
    train/     optax training loop, early stopping, checkpointing
    bench/     benchmark suite mirroring the reference's table schema
    parallel/  mesh / shard_map distributed SpMV + PCG (halo exchange, psum)
    native/    ctypes bindings to the C++ host-side runtime (index builders,
               factorizations), with pure-numpy fallbacks
"""

from deeppreconditioning_tpu.runtime import configure_compile_cache

__version__ = "0.1.0"

configure_compile_cache()
