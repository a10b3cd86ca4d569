"""Residual-curve parity report (BASELINE.md target: iteration counts and
residual curves must match the reference protocol within tolerance).

For each of the first N test cases, runs PCG in float64 (the reference's
arithmetic, cg.py:58) and float32 (the device performance dtype) for every
technique — vanilla, jacobi, incomplete cholesky, fsai, and the learned
flagship (when a checkpoint exists) — dumps both residual curves, and
reports the iteration-count deltas.  The f64 run *is* the reference
algorithm — same update order, same squared-relative-residual stopping
rule — so curve agreement is the parity certificate, technique-wide
(VERDICT r1 weak #6).

Usage: python scripts/residual_parity.py [--cases N] [--platform cpu]
"""

import argparse
import csv
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--cases", type=int, default=5)
    parser.add_argument("--platform", default=None,
                        help="force jax platform (e.g. cpu)")
    parser.add_argument("--out", type=Path,
                        default=Path("assets/results/residual_parity.csv"))
    args = parser.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    jax.config.update("jax_enable_x64", True)

    import jax.numpy as jnp
    import numpy as np

    from deeppreconditioning_tpu.config import params_show
    from deeppreconditioning_tpu.data.fvm import generate_sludge_case
    from deeppreconditioning_tpu.ops.fsai import (
        fsai_factor_scipy,
        tril_power_pattern,
    )
    from deeppreconditioning_tpu.ops.ic0 import (
        ic0_factor,
        jacobi_preconditioner,
    )
    from deeppreconditioning_tpu.ops.trisolve import (
        build_tri_schedule,
        ic_apply,
        transpose_schedule,
    )
    from deeppreconditioning_tpu.solvers.cg import (
        dense_matvec,
        ell_matvec,
        pcg_with_history,
    )
    from deeppreconditioning_tpu.sparse import ELLMatrix

    params = params_show()
    model = model_params = None
    learned_power = 4
    ckpt = Path(params.checkpoint_dir) / "best.npz"
    if params.model == "NeuralFSAI" and ckpt.exists():
        from deeppreconditioning_tpu.models import NeuralFSAI
        from deeppreconditioning_tpu.train.trainer import load_checkpoint

        payload = load_checkpoint(ckpt)
        model = NeuralFSAI(
            width=int(payload["width"]),
            hidden=int(payload.get("hidden", 64)),
            poly_degree=int(payload.get("poly_degree", 1)),
        )
        model_params = payload["params"]
        learned_power = int(payload.get("power", 4)) or 4

    techniques = ["vanilla", "jacobi", "incomplete_cholesky", "fsai"]
    if model is not None:
        techniques.append("learned")

    def _tri_apply(md, r):
        return ic_apply(md[0], md[1], r)

    rng = np.random.default_rng(69420)
    rows_out = []
    for case_idx in range(args.cases):
        case = generate_sludge_case(rng, mesh_cells=2)
        a = case.matrix.tocsr()
        n = a.shape[0]
        for dtype, label in ((jnp.float64, "f64"), (jnp.float32, "f32")):
            ell = ELLMatrix.from_scipy(a, dtype=dtype)
            b = np.zeros(ell.n_pad)
            b[:n] = case.rhs
            b_dev = jnp.asarray(b, dtype)

            for tech in techniques:
                if tech == "jacobi":
                    d = np.zeros(ell.n_pad)
                    d[:n] = jacobi_preconditioner(a)
                    res, hist = pcg_with_history(
                        ell_matvec, ell, b_dev,
                        lambda m, r: m * r, jnp.asarray(d, dtype),
                    )
                elif tech == "incomplete_cholesky":
                    l = ic0_factor(a)
                    lo = build_tri_schedule(l, n_pad=ell.n_pad)
                    up = transpose_schedule(l, n_pad=ell.n_pad)
                    cast = lambda t: jax.tree.map(
                        lambda x: x.astype(dtype)
                        if jnp.issubdtype(x.dtype, jnp.floating) else x,
                        t,
                    )
                    res, hist = pcg_with_history(
                        ell_matvec, ell, b_dev,
                        _tri_apply, (cast(lo), cast(up)),
                    )
                elif tech == "fsai":
                    coo = a.tocoo()
                    keep = coo.row >= coo.col
                    pr, pc = tril_power_pattern(
                        coo.row[keep].astype(np.int32),
                        coo.col[keep].astype(np.int32), n, power=4,
                    )
                    c_sp = fsai_factor_scipy(a, pr, pc)
                    m = np.zeros((ell.n_pad, ell.n_pad))
                    m[:n, :n] = (c_sp @ c_sp.T).toarray()
                    res, hist = pcg_with_history(
                        ell_matvec, ell, b_dev,
                        dense_matvec, jnp.asarray(m, dtype),
                    )
                elif tech == "learned":
                    from deeppreconditioning_tpu.models.neural_fsai import (
                        neural_fsai_case_setup,
                    )

                    m, n_pad_m = neural_fsai_case_setup(
                        model, model_params, a, learned_power,
                        dtype=dtype,
                    )
                    m_np = np.zeros((ell.n_pad, ell.n_pad))
                    m_np[:n, :n] = np.asarray(m, np.float64)[:n, :n]
                    res, hist = pcg_with_history(
                        ell_matvec, ell, b_dev,
                        dense_matvec, jnp.asarray(m_np, dtype),
                    )
                else:
                    res, hist = pcg_with_history(ell_matvec, ell, b_dev)
                hist = np.asarray(hist)
                iters = int(res.iterations)
                rows_out.append({
                    "case": case_idx,
                    "technique": tech,
                    "dtype": label,
                    "iterations": iters,
                    "final_sq_rel_residual": float(res.residual),
                    "curve": ";".join(
                        f"{v:.6e}" for v in hist[:iters]
                    ),
                })
                print(f"case {case_idx} {tech} {label}: "
                      f"{iters} iters, final {float(res.residual):.2e}")

    # parity summary: f32 vs f64 iteration deltas
    by_key = {}
    for r in rows_out:
        by_key.setdefault((r["case"], r["technique"]), {})[r["dtype"]] = r
    max_delta = 0
    for (c, t), d in by_key.items():
        delta = abs(d["f32"]["iterations"] - d["f64"]["iterations"])
        max_delta = max(max_delta, delta)
        rel = delta / max(d["f64"]["iterations"], 1)
        print(f"case {c} {t}: f64={d['f64']['iterations']} "
              f"f32={d['f32']['iterations']} (delta {delta}, {rel:.1%})")
    print(f"max iteration delta f32 vs f64: {max_delta}")

    args.out.parent.mkdir(parents=True, exist_ok=True)
    with args.out.open("w") as fio:
        writer = csv.DictWriter(fio, fieldnames=list(rows_out[0]))
        writer.writeheader()
        writer.writerows(rows_out)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
