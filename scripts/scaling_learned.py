"""Learned preconditioner at scale: 64^3 / 128^3 Poisson on the chip.

The BASELINE.md scaling target (VERDICT r3 next #3): show the learned
technique's iteration crown converting to wall clock where iterations
dominate — single large systems, DIA operator, factor-form structured
apply (ops/structured_fsai.py), the trained width-local head from
scripts/train_structured.py deployed at grids it never saw.

Per technique (vanilla / jacobi / fsai / learned / gmg_jacobi /
gmg_learned): setup seconds (chained reps, one sync), solve seconds
(chained full PCG solves), iterations, and the total; written to
assets/results/scaling_learned.csv and printed as JSON for bench.py's
scaling section.

Usage: python scripts/scaling_learned.py [--shapes 64,128]
    [--ckpt assets/checkpoints_structured/best.npz] [--reps 4]
    [--sigma 0] [--out CSV]
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

REPO = Path(__file__).resolve().parent.parent


def run_scaling(shapes, ckpt, sigma=1.0, reps=4, rtol=1e-8,
                out=None, k_solves=None, seq_out=None, rhs="random",
                gmg=True, with_amg=False, smoother_ckpt=None,
                techniques=None, solutions=None):
    """Run the scaling comparison; returns (rows, details).

    ``techniques`` (a set of names) restricts what is set up and solved;
    ``solutions``, a dict, receives each solve's host solution vector
    and right-hand side under ``(side, name)``.

    Importable by bench.py, which runs it in its own process: one
    process per device (a second one could not reserve the device's
    memory).
    """
    import jax
    import jax.numpy as jnp
    import numpy as np

    from deeppreconditioning_tpu.data.poisson import (
        poisson_coeff_dia,
        poisson_rhs_sequence,
    )
    from deeppreconditioning_tpu.ops.structured_fsai import (
        bands_to_dia,
        build_structured_plan,
        dia_sorted_by_offset,
        make_structured_poly_apply_dia,
        structured_setup,
    )
    from deeppreconditioning_tpu.solvers.cg import (
        pcg_fixed_trips,
        pcg_sequence_fixed_trips,
        preconditioned_conjugate_gradient,
    )
    from deeppreconditioning_tpu.sparse.dia import poisson_dia
    from deeppreconditioning_tpu.train.trainer import load_checkpoint
    from deeppreconditioning_tpu.utils.profiling import (
        next_unique,
        sync,
        time_chain,
    )

    ckpt_path = Path(ckpt)
    payload = load_checkpoint(ckpt_path)
    power = int(payload["power"])
    degree = int(payload["poly_degree"])
    params = payload["params"]
    print(f"checkpoint: width={payload['width']} degree={degree} "
          f"power={power} trained@{payload.get('train_shape')}",
          flush=True)
    smoother_params, smoother_power = None, 1
    if gmg:
        sc = Path(smoother_ckpt) if smoother_ckpt else (
            ckpt_path.parent / "deg0_p1.npz"
        )
        if sc.exists():
            sp_ = load_checkpoint(sc)
            smoother_params = sp_["params"]
            smoother_power = int(sp_["power"])
            print(f"gmg smoother head: {sc.name} "
                  f"power={smoother_power}", flush=True)

    def matvec(a_data, x):
        # every technique's CG operator: the fused DIA matvec
        return a_data.matvec(x)

    def write_csv(path, rs):
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        keys = list(rs[0].keys())
        if any("safeguard_fallback" in r for r in rs):
            keys = [k for k in rs[0] if k != "safeguard_fallback"]
            keys.append("safeguard_fallback")
        with path.open("w") as fio:
            fio.write(",".join(keys) + "\n")
            for r in rs:
                fio.write(",".join(
                    str(r.get(k, "")) for k in keys
                ) + "\n")

    def flush_csvs():
        # incremental: a late-technique failure must not discard the
        # rows already measured
        if out is not None and rows:
            write_csv(out, rows)
        if seq_out is not None and seq_rows:
            write_csv(seq_out, seq_rows)

    only = None if techniques is None else set(techniques)

    def want(name):
        return only is None or name in only

    rows = []
    seq_rows = []
    details = {}
    for side in shapes:
        shape = (side, side, side)
        if sigma > 0:
            a = poisson_coeff_dia(
                shape, rng=np.random.default_rng(1), sigma=sigma,
                dtype=jnp.float32,
            )
        else:
            a = poisson_dia(shape, dtype=jnp.float32)
        a = dia_sorted_by_offset(a)
        n = a.n
        rng = np.random.default_rng(2)
        if rhs == "ax":
            # known-solution rhs (b = A x*): exact-error reporting, but
            # self-regularizing — the hard modes' rhs components are
            # scaled down by their own tiny eigenvalues, so iteration
            # counts underestimate the physical workload
            x_star = np.zeros(a.n_pad, np.float32)
            x_star[:n] = rng.standard_normal(n)
            b = jnp.asarray(np.asarray(a.matvec(jnp.asarray(x_star))))
        else:
            # physical rhs (A-independent source, the reference's real
            # workload shape: pEqn.H:43-46's rhs is div(phiHbyA), not
            # A times anything): the solver must resolve the
            # ill-conditioned modes — iterations triple vs b = A x*
            x_star = None
            b_np = np.zeros(a.n_pad, np.float32)
            b_np[:n] = rng.standard_normal(n)
            b = jnp.asarray(b_np)
        plan = build_structured_plan(shape, power=power)
        diag_idx = a.offsets.index(0)
        inv_diag = jnp.where(
            a.vals[diag_idx] == 0, 0.0, 1.0 /
            jnp.where(a.vals[diag_idx] == 0, 1.0, a.vals[diag_idx])
        )

        def time_setup(fn, reps):
            """Clean warm-up result + scan-chained two-point timing
            (utils/profiling.time_chain — every rep distinct and
            carry-tied); a sub-noise setup gets a wider rep spread;
            negative slopes clamp to 0."""
            out0 = fn(a, jnp.zeros((), jnp.float32))
            sync(out0)
            secs = time_chain(
                fn, a,
                lambda i: jnp.float32(next_unique() * 1.2e-7),
                reps=(max(reps // 3, 2), reps),
            )
            if secs < 2e-3:
                secs = time_chain(
                    fn, a,
                    lambda i: jnp.float32(next_unique() * 1.2e-7),
                    reps=(reps, reps * 4),
                )
            return out0, max(secs, 0.0)

        techniques = {}
        if want("vanilla"):
            techniques["vanilla"] = (None, None, 0.0)

        def jitter_a(a_, jit):
            return jax.tree.map(
                lambda x: (x * (1.0 + jit)
                           if x.dtype == jnp.float32 else x),
                a_,
            )

        def jacobi_build(a_, jit):
            a_j = jitter_a(a_, jit)
            d = a_j.vals[diag_idx]
            return jnp.where(d == 0, 0.0,
                             1.0 / jnp.where(d == 0, 1.0, d))

        def diag_apply(m_data, r):
            return m_data * r

        if want("jacobi"):
            md, setup_s = time_setup(jacobi_build, reps)
            techniques["jacobi"] = (diag_apply, md, setup_s)

        # full timed setup: scale -> local solves -> (refine + spectral
        # safeguard) -> fold -> DIA operator views for the apply
        def make_setup(p):
            def fn(a_, jit):
                bands, q = structured_setup(jitter_a(a_, jit), plan, p)
                c_up, c_low = bands_to_dia(bands, plan.offsets, a.n)
                return c_up, c_low, q
            return fn

        if want("fsai"):
            (c_up, c_low, q), setup_s = time_setup(make_setup(None), reps)
            apply_fsai = make_structured_poly_apply_dia(0)
            techniques["fsai"] = (apply_fsai, (c_up, c_low, q, a), setup_s)

        learned_fell_back = None
        if want("learned"):
            (c_up_l, c_low_l, q_l), setup_s = time_setup(
                make_setup(params), reps
            )
            apply_learned = make_structured_poly_apply_dia(degree)
            techniques["learned"] = (
                apply_learned, (c_up_l, c_low_l, q_l, a), setup_s
            )
            learned_fell_back = bool(np.allclose(
                np.asarray(q_l),
                np.eye(1, int(np.asarray(q_l).shape[0]))[0],
            ))

        # geometric multigrid (ops/gmg.py): Jacobi-smoothed classical
        # baseline + learned-FSAI-smoothed variant.  The build is one
        # jitted dispatch (device root inverse), so it scan-times like
        # every other setup.
        if gmg:
            from deeppreconditioning_tpu.ops.gmg import (
                build_gmg,
                gmg_apply,
            )

            def gmg_ap(md, r):
                return gmg_apply(md, r)

            if want("gmg_jacobi"):
                m_gj, setup_s = time_setup(
                    lambda a_, jit: build_gmg(jitter_a(a_, jit), shape),
                    8,
                )
                techniques["gmg_jacobi"] = (gmg_ap, m_gj, setup_s)

            # learned head smooths the FINEST level only: coarse-level
            # error modes are the recursion's job, and fine-only keeps
            # both the setup and the cycle near gmg_jacobi's cost while
            # keeping most of the iteration win
            if want("gmg_learned"):
                m_gl, setup_s = time_setup(
                    lambda a_, jit: build_gmg(
                        jitter_a(a_, jit), shape,
                        params=smoother_params,
                        plan_power=smoother_power,
                        fsai_smoother=True, fsai_levels=1,
                    ), 8
                )
                techniques["gmg_learned"] = (gmg_ap, m_gl, setup_s)

        if with_amg and want("amg"):
            from deeppreconditioning_tpu.ops.amg import (
                amg_apply,
                build_amg,
            )

            def amg_ap(md, r):
                return amg_apply(md, r)

            # host-dominated (~30 s at 128^3): one honest rep
            t0 = time.perf_counter()
            csr = jitter_a(a, jnp.float32(
                next_unique() * 1.2e-7)).to_scipy()
            m_amg = build_amg(csr, n_pad=a.n_pad)
            sync(m_amg.coarse_inv)
            techniques["amg"] = (
                amg_ap, m_amg, time.perf_counter() - t0
            )

        # flat single-system solvers (see solvers/cg.pcg_fixed_trips).
        # The untimed warm-up while-loop measures needed iterations;
        # the timed dispatch is fixed-trip (no device-to-host round
        # trip per convergence check)
        for name, (apply_fn, m_data, setup_s) in techniques.items():
            kwargs = {}
            if apply_fn is not None:
                kwargs = {"apply_m": apply_fn, "m_data": m_data}
            warm = preconditioned_conjugate_gradient(
                matvec, a, b, rtol=rtol, **kwargs
            )
            jax.block_until_ready(warm.x)
            iters = int(warm.iterations)
            ok = float(warm.residual) < rtol
            trips = min(iters + 2, 1024)
            res = pcg_fixed_trips(
                matvec, a, b, rtol=rtol, trips=trips, **kwargs
            )
            jax.block_until_ready(res.x)
            if solutions is not None:
                solutions[(side, name)] = (np.asarray(res.x), np.asarray(b))
            # accuracy from the UNSCALED-b fixed-trip solve: the timed
            # variants below scale b by 1+k*1.2e-7, which would floor
            # the reported relative error near ~5e-7 regardless of the
            # actual solve accuracy (ADVICE r4 #2).  random-rhs mode has
            # no known solution; the converged flag carries correctness
            err = (float(jnp.linalg.norm(res.x[:n] - x_star[:n])
                         / np.linalg.norm(x_star[:n]))
                   if x_star is not None else float("nan"))

            def solve_fn(ops, b_, _ap=apply_fn, _tr=trips):
                a_, md = ops
                if _ap is None:
                    return pcg_fixed_trips(
                        matvec, a_, b_, rtol=rtol, trips=_tr
                    )
                return pcg_fixed_trips(
                    matvec, a_, b_, apply_m=_ap, m_data=md,
                    rtol=rtol, trips=_tr,
                )

            solve_s = time_chain(
                solve_fn,
                (a, m_data),
                lambda i: b * (
                    1.0 + next_unique() * jnp.float32(1.2e-7)
                ),
                reps=(max(reps // 3, 2), reps),
            )
            rows.append({
                "shape": f"{side}^3", "technique": name, "n": n,
                "sigma": sigma,
                "iterations": iters,
                "setup_s": round(setup_s, 6),
                "solve_s": round(solve_s, 6),
                "total_s": round(setup_s + solve_s, 6),
                "converged": ok, "x_rel_err": round(err, 8),
            })
            if name == "learned":
                rows[-1]["safeguard_fallback"] = learned_fell_back
            details[f"{side}_{name}"] = {
                "it": iters, "total_ms": round(
                    (setup_s + solve_s) * 1e3, 1),
            }
            print(rows[-1], flush=True)
            flush_csvs()

            # multi-RHS / time-stepping protocol (VERDICT r4 next #3):
            # k solves of the SAME operator with an evolving rhs in one
            # scan dispatch — the workload shape of the reference's
            # PIMPLE corrector loop (pEqn.H:43-49).  Reuses this
            # technique's setup; reports total_s(k) = setup + solves.
            # amg sits out the sequence protocol (its gather-heavy
            # apply is not a contender for repeated solves)
            for k in (() if name == "amg" else (k_solves or ())):
                if x_star is not None:
                    b_seq = jnp.asarray(poisson_rhs_sequence(
                        a, k, np.random.default_rng(7 + k)
                    )[0])
                else:
                    # evolving SOURCE sequence (random-rhs protocol):
                    # the rhs itself random-walks, as the physical
                    # source terms do across PIMPLE correctors
                    rk = np.random.default_rng(7 + k)
                    seq = np.zeros((k, a.n_pad), np.float32)
                    cur = np.asarray(b).copy()
                    for t in range(k):
                        seq[t] = cur
                        cur = cur.copy()
                        cur[:n] += 0.1 * rk.standard_normal(n).astype(
                            np.float32
                        )
                    b_seq = jnp.asarray(seq)
                # headroom over the single-rhs trip count: the drifting
                # rhs can need a few more iterations than b did
                trips = min(int(iters * 1.3) + 4, 1024)
                xs, its_seq, ress = pcg_sequence_fixed_trips(
                    matvec, a, b_seq, rtol=rtol, trips=trips, **kwargs
                )
                sync(xs)
                seq_ok = bool((np.asarray(ress) < rtol).all())

                def seq_fn(ops, bs_, _ap=apply_fn, _tr=trips):
                    a_, md = ops
                    if _ap is None:
                        return pcg_sequence_fixed_trips(
                            matvec, a_, bs_, rtol=rtol, trips=_tr
                        )
                    return pcg_sequence_fixed_trips(
                        matvec, a_, bs_, apply_m=_ap, m_data=md,
                        rtol=rtol, trips=_tr,
                    )

                best_k = time_chain(
                    seq_fn, (a, m_data),
                    lambda i: b_seq * (
                        1.0 + next_unique() * jnp.float32(1.2e-7)
                    ),
                    reps=(2, max(reps // 2, 4)),
                )
                seq_rows.append({
                    "shape": f"{side}^3", "technique": name, "n": n,
                    "sigma": sigma, "k_solves": k,
                    "iterations_mean": round(
                        float(np.asarray(its_seq).mean()), 2),
                    "setup_s": round(setup_s, 6),
                    "solves_s": round(best_k, 6),
                    "total_s": round(setup_s + best_k, 6),
                    "converged": seq_ok,
                })
                print(seq_rows[-1], flush=True)
                flush_csvs()

        # measured crossover: smallest k where the learned total beats
        # every classical technique's total at the same k
        if k_solves:
            for k in k_solves:
                at_k = {r["technique"]: r["total_s"] for r in seq_rows
                        if r["k_solves"] == k
                        and r["shape"] == f"{side}^3"}
                if "learned" in at_k and at_k["learned"] <= min(
                    v for t, v in at_k.items() if t != "learned"
                ):
                    details[f"{side}_crossover_k"] = k
                    break

    flush_csvs()
    return rows, details


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--shapes", default="64,128")
    parser.add_argument(
        "--ckpt",
        default=str(REPO / "assets" / "checkpoints_structured"
                    / "best.npz"),
    )
    parser.add_argument("--reps", type=int, default=12)
    parser.add_argument("--sigma", type=float, default=1.0,
                        help="coefficient-field contrast (lognormal "
                        "sigma; the checkpoint's training family) — "
                        "0 gives the constant-coefficient ladder")
    parser.add_argument("--rtol", type=float, default=1e-8)
    parser.add_argument(
        "--out",
        default=str(REPO / "assets" / "results"
                    / "scaling_learned.csv"),
    )
    parser.add_argument("--platform", default=None,
                        choices=["cpu", "gpu"])
    parser.add_argument("--with-amg", action="store_true",
                        help="include the aggregation-AMG technique "
                        "(host setup ~30 s at 128^3)")
    parser.add_argument("--no-gmg", action="store_true")
    parser.add_argument("--smoother-ckpt", default=None)
    parser.add_argument("--rhs", default="random",
                        choices=["random", "ax"],
                        help="rhs protocol: 'random' (A-independent "
                        "physical source) or 'ax' (b = A x*, known "
                        "solution)")
    parser.add_argument(
        "--k-solves", default="",
        help="comma list of sequence lengths for the multi-RHS "
        "protocol (e.g. 2,4,8); empty disables it",
    )
    parser.add_argument(
        "--seq-out",
        default=str(REPO / "assets" / "results" / "multi_rhs.csv"),
    )
    args = parser.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    ks = [int(s) for s in args.k_solves.split(",") if s]
    _, details = run_scaling(
        [int(s) for s in args.shapes.split(",")],
        args.ckpt, sigma=args.sigma, reps=args.reps, rtol=args.rtol,
        out=args.out, k_solves=ks or None,
        seq_out=args.seq_out if ks else None, rhs=args.rhs,
        gmg=not args.no_gmg, with_amg=args.with_amg,
        smoother_ckpt=args.smoother_ckpt,
    )
    print("JSON:" + json.dumps(details), flush=True)


if __name__ == "__main__":
    main()
