"""Large-system solve demo: CG on a 3-D Poisson system at chip scale.

The reference caps problems at ~2000 cells (SURVEY.md §6); this is the
rebuild's scaling story on one chip: matrix-free CG on the 7-point
Poisson operator with the zero-copy padded stencil matvec — 16.7M dof at
256^3 in f32 — optionally Jacobi-free (the operator has constant
diagonal 6, so Jacobi == scalar scaling and vanilla CG is the honest
baseline).

Usage: python scripts/large_solve.py [--grid 256] [--max-iter 1024]
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--grid", type=int, default=256)
    parser.add_argument("--max-iter", type=int, default=1024)
    parser.add_argument("--rtol", type=float, default=1e-8)
    args = parser.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from deeppreconditioning_tpu.ops.pallas_stencil import (
        StencilOperator3D,
        stencil_matvec_flat,
    )
    from deeppreconditioning_tpu.solvers.cg import conjugate_gradient

    g = args.grid
    shape = (g, g, g)
    n = g ** 3
    # flat formulation (see the ops/pallas_stencil.py note)
    op = StencilOperator3D(shape=shape)
    rng = np.random.default_rng(0)
    b = rng.standard_normal(n).astype(np.float32)
    bp = jnp.asarray(b)

    # warm-up / compile
    res = conjugate_gradient(stencil_matvec_flat, op, bp,
                             rtol=args.rtol, max_iter=args.max_iter)
    jax.block_until_ready(res)
    start = time.perf_counter()
    res = conjugate_gradient(stencil_matvec_flat, op, bp,
                             rtol=args.rtol, max_iter=args.max_iter)
    jax.block_until_ready(res)
    dt = time.perf_counter() - start

    iters = int(res.iterations)
    x = np.asarray(res.x)
    print(f"grid {g}^3: n={n:,} dof, {iters} iterations in {dt:.2f}s "
          f"({iters / dt:.0f} it/s, "
          f"{n * iters / dt / 1e9:.2f} Gdof-updates/s), "
          f"final squared rel resid {float(res.residual):.2e}")


if __name__ == "__main__":
    main()
