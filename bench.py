"""Round benchmark — prints ONE JSON line for the driver.

Headline metric: end-to-end PCG total time (setup + solve, the
reference's "totals" column, test.py:148) of the learned preconditioner
vs Jacobi on the sludge-pattern test split, run on the GPU.
``vs_baseline`` is the speedup over Jacobi — the reference publishes no
absolute numbers (BASELINE.md), so the classical-preconditioner-on-
same-hardware ratio is the comparable quantity.

Extra context rides in "details": per-technique mean iterations/totals
and an ELL SpMV throughput microbenchmark (Gnnz/s) on a 512^2 Poisson
system.
"""

import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))

REPO = Path(__file__).resolve().parent


def _ensure_dataset(root: Path, samples: int = 500) -> None:
    out = root / "sludge_patterns"
    if out.exists() and len(list(out.glob("case_*"))) >= samples:
        return
    from deeppreconditioning_tpu.data.fvm import (
        generate_sludge_case,
        save_case,
    )

    rng = np.random.default_rng(69420)
    for i in range(samples):
        case = generate_sludge_case(rng, mesh_cells=2)
        save_case(case, out / f"case_{i:04d}")


def _ensure_dataset_3d(root: Path, samples: int = 100) -> None:
    out = root / "sludge_patterns_3d"
    if out.exists() and len(list(out.glob("case_*"))) >= samples:
        return
    from deeppreconditioning_tpu.data.fvm import (
        generate_sludge_case_3d,
        save_case,
    )

    rng = np.random.default_rng(69421)
    for i in range(samples):
        case = generate_sludge_case_3d(
            rng, mesh_cells=2, castellated=True, permute=bool(i % 2)
        )
        save_case(case, out / f"case_{i:04d}")


def _irregular_split(model, model_params, root: Path) -> dict:
    """Benchmark the non-banded split: 3-D castellated meshes, half with
    randomly permuted cell numbering — build_range_fsai_plan raises on
    the permuted half, so the generic element-gather FSAI plans carry
    the learned/fsai techniques (VERDICT r1 weak #2)."""
    from deeppreconditioning_tpu.bench.suite import BenchmarkSuite
    from deeppreconditioning_tpu.data.datasets import SludgePatternDataSet
    from deeppreconditioning_tpu.models import plan_builder_for

    _ensure_dataset_3d(root)
    specs = plan_builder_for("NeuralFSAI", None)
    ds = SludgePatternDataSet(
        stage="test", batch_size=1, specs=specs, shuffle=False,
        root=root, family="sludge_patterns_3d",
    )
    techniques = ("vanilla", "jacobi", "fsai")
    if model is not None and model_params is not None:
        techniques = techniques + ("learned",)
    suite = BenchmarkSuite(
        ds, model, model_params,
        techniques=techniques,
        kappa_cases=0,
        timing_reps=10,
        fsai_power=2,  # 3-D power-4 patterns exceed practical widths
        learned_power=2,
        results_directory=REPO / "assets" / "results" / "irregular_driver",
    )
    suite.run()
    suite.dump_csv()
    return {
        f"irregular_{name}": {
            "iterations": stats["iterations"],
            "total_ms": stats["total"] * 1e3,
            "success": stats["success"],
        }
        for name, stats in suite.summary().items()
    }


def _spmv_throughput() -> dict:
    """Banded SpMV Gnnz/s of the fused DIA matvec on 2-D 512^2 and 3-D
    7-point Poisson (the BASELINE.md roofline family), one device.

    Kernel timing: cold-streamed (an operator pool larger than the
    on-chip cache, two-point time_chain slope —
    utils/profiling.time_cold_stream)."""
    import jax
    import jax.numpy as jnp

    from deeppreconditioning_tpu.sparse.dia import poisson_dia

    from deeppreconditioning_tpu.ops.pallas_stencil import (
        poisson3d_stencil_matvec,
    )
    from deeppreconditioning_tpu.utils.profiling import (
        time_cold_stream,
    )

    out = {}
    for label, shape in (("spmv_2d_512", (512, 512)),
                         ("spmv_3d_128", (128, 128, 128)),
                         ("spmv_3d_256", (256, 256, 256))):
        a = poisson_dia(shape, dtype=jnp.float32)
        nnz = int(np.count_nonzero(np.asarray(a.vals)))
        x = jnp.asarray(
            np.random.default_rng(0).standard_normal(a.n_pad),
            jnp.float32,
        )
        offs, n_ = a.offsets, a.n
        dt = time_cold_stream(
            lambda vals, v, _o=offs, _n=n_: type(a)(
                vals=vals, offsets=_o, n=_n).matvec(v),
            a.vals, x,
        )
        out[label] = {
            "n": a.n,
            "nnz": nnz,
            "gnnz_per_s": round(nnz / dt / 1e9, 3),
            "us": round(dt * 1e6, 1),
        }
        if len(shape) == 3:  # constant-coefficient stencil fast path
            # the flat pad-based formulation (ops/pallas_stencil.py)
            xs = x[: shape[0] * shape[1] * shape[2]]
            dt = time_cold_stream(
                lambda xe, s, shp=shape: poisson3d_stencil_matvec(
                    xe * s, shp),
                xs, jnp.float32(1.0),
            )
            out[label + "_stencil"] = {
                "gnnz_per_s": round(nnz / dt / 1e9, 3),
                "us": round(dt * 1e6, 1),
            }
        del a, x
    return out


def _scaling_section() -> dict:
    """Scaling comparison at 64^3 AND 128^3 (structured-grid learned
    FSAI + geometric multigrid vs jacobi/fsai/vanilla —
    scripts/scaling_learned.py machinery, in this process: one process
    holds the device).  The 128^3 slice is the BASELINE.md wall-clock
    headline: the learned-smoothed GMG technique's total vs
    Jacobi's."""
    cdir = REPO / "assets" / "checkpoints_structured"
    ckpt = cdir / "deg1_random.npz"  # random-rhs-trained flagship
    if not ckpt.exists():
        ckpt = cdir / "best.npz"
    if not ckpt.exists():
        return {}
    sys.path.insert(0, str(REPO / "scripts"))
    from scaling_learned import run_scaling

    _, details = run_scaling(
        [64, 128], ckpt, sigma=1.0, reps=8,
        out=REPO / "assets" / "results" / "driver"
        / "scaling_learned.csv",
    )
    return {"scaling": details}


def main() -> None:
    from deeppreconditioning_tpu.bench.suite import BenchmarkSuite
    from deeppreconditioning_tpu.config import params_show
    from deeppreconditioning_tpu.data.datasets import SludgePatternDataSet
    from deeppreconditioning_tpu.config import (
        get_model_class,
    )
    from deeppreconditioning_tpu.models import plan_builder_for
    from deeppreconditioning_tpu.train.trainer import load_checkpoint

    params = params_show(REPO / "params.yaml")
    root = REPO / params.data_root
    _ensure_dataset(root)

    specs = plan_builder_for(params.model, params.channels)
    data_set = SludgePatternDataSet(
        stage="test", batch_size=1, specs=specs, shuffle=False, root=root
    )
    # full reference-protocol test split: 100 of 500 cases
    # (reference params.yaml:3 + data_set.py:40-46 80/20 split)

    ckpt = REPO / params.checkpoint_dir / "best.npz"
    model_params = None
    if params.model == "NeuralFSAI":
        from deeppreconditioning_tpu.models import NeuralFSAI

        model = None
        if ckpt.exists():
            payload = load_checkpoint(ckpt)
            model = NeuralFSAI(
                width=int(payload["width"]),
                hidden=int(payload.get("hidden", 64)),
                poly_degree=int(payload.get("poly_degree", 1)),
            )
            model_params = payload["params"]
    else:
        model = get_model_class(params.model)(
            channels=tuple(params.channels)
        )
        if ckpt.exists():
            model_params = load_checkpoint(ckpt)["params"]

    techniques = (
        ("vanilla", "jacobi", "incomplete_cholesky",
         "incomplete_cholesky_neumann", "algebraic_multigrid",
         "fsai", "learned")
        if model_params is not None
        else ("vanilla", "jacobi", "incomplete_cholesky",
              "incomplete_cholesky_neumann", "algebraic_multigrid",
              "fsai")
    )
    suite_kwargs = {}
    if params.model == "NeuralFSAI" and model_params is not None:
        # the learned plan pattern must match the training pattern; the
        # classical fsai baseline stays at its own total-time optimum
        suite_kwargs["learned_power"] = int(payload.get("power", 4)) or 4
    suite = BenchmarkSuite(
        data_set, model, model_params,
        techniques=techniques,
        kappa_cases=0,
        timing_reps=10,  # chained reps, one sync per rep block
        results_directory=REPO / "assets" / "results" / "driver",
        **suite_kwargs,
    )
    suite.run()
    summary = suite.summary()

    details = {
        name: {
            "iterations": stats["iterations"],
            "total_ms": stats["total"] * 1e3,
            "solve_ms": stats["duration"] * 1e3,
            "success": stats["success"],
        }
        for name, stats in summary.items()
    }

    # batched protocol: the whole test split in one compiled
    # setup + one fixed-trip PCG dispatch per technique (suite.run_batched)
    batched = suite.run_batched()
    suite.dump_csv_batched()
    details["batched"] = {
        name: {
            "iterations": round(stats["iterations"], 2),
            "setup_ms": round(stats["setup_batch"] * 1e3, 2),
            "solve_ms": round(stats["solve_batch"] * 1e3, 2),
            "total_ms": round(stats["total_batch"] * 1e3, 2),
            "per_case_us": round(stats["per_case_total"] * 1e6, 1),
            "success": stats["success"],
        }
        for name, stats in batched.items()
    }
    # ratios live apart from the per-technique dicts so consumers
    # iterating details["batched"].items() only ever see dicts; .get
    # guards cover a filtered-out technique (ADVICE r3 #3)
    ratios = {}
    learned_b = batched.get("learned")
    if learned_b is not None:
        for other in ("jacobi", "fsai"):
            st = batched.get(other)
            if st is not None:
                ratios[f"learned_vs_{other}"] = round(
                    st["total_batch"] / learned_b["total_batch"], 4
                )
    details["batched_ratios"] = ratios
    # untimed input-prep cost (pattern powers + plan builds), reported
    # next to setup as the reference times full construction
    details["input_prep_s"] = {
        k: round(v, 3)
        for k, v in getattr(suite, "prep_seconds", {}).items()
    }
    details.update(_irregular_split(
        model if params.model == "NeuralFSAI" else None,
        model_params if params.model == "NeuralFSAI" else None,
        root,
    ))
    details.update(_spmv_throughput())
    details.update(_scaling_section())

    if "learned" in summary:
        speedup = (
            summary["jacobi"]["total"] / summary["learned"]["total"]
        )
        metric = "learned_vs_jacobi_total_speedup"
    else:
        speedup = (
            summary["vanilla"]["duration"] / summary["jacobi"]["duration"]
        )
        metric = "jacobi_vs_vanilla_solve_speedup"

    # full per-technique dump -> file; the printed line stays compact.
    # The r3 driver record came back "parsed": null because the one-line
    # JSON outgrew the driver's ~1.8 KB tail buffer (BENCH_r03.json tail
    # vs BENCH_r02.json:6) — the driver must see a complete JSON line.
    out_dir = REPO / "assets" / "results" / "driver"
    out_dir.mkdir(parents=True, exist_ok=True)
    with (out_dir / "bench_details.json").open("w") as fio:
        json.dump(details, fio, indent=1)

    def _pick(stats, keys=("iterations", "total_ms")):
        return {k: round(float(stats[k]), 2) for k in keys if k in stats}

    compact = {
        "percase": {
            t: _pick(details[t])
            for t in ("jacobi", "fsai", "learned") if t in details
        },
        "batched": {
            t: _pick(details["batched"][t])
            for t in ("jacobi", "fsai", "learned")
            if t in details["batched"]
        },
        "batched_ratios": ratios,
        "irregular": {
            t: _pick(details[f"irregular_{t}"])
            for t in ("jacobi", "learned")
            if f"irregular_{t}" in details
        },
        "spmv_gnnz": {
            k.removeprefix("spmv_"): details[k]["gnnz_per_s"]
            for k in details if k.startswith("spmv_")
        },
    }
    if "scaling" in details:
        compact["scaling"] = details["scaling"]

    def _line():
        return json.dumps({
            "metric": metric,
            "value": round(float(speedup), 4),
            "unit": "x",
            "vs_baseline": round(float(speedup), 4),
            "details": compact,
        })

    # the driver's tail buffer is finite (~1.8 KB; the r3 record came
    # back "parsed": null when the line outgrew it) — on overflow drop
    # optional sections least-important-first instead of crashing after
    # the full chip-holding benchmark run (ADVICE r4 #1)
    line = _line()
    if len(line) >= 1500 and "scaling" in compact:
        # keep the 128^3 headline rows, shed the 64^3 slice first
        compact["scaling"] = {
            k: v for k, v in compact["scaling"].items()
            if k.startswith("128")
        }
        line = _line()
    for optional in ("irregular", "spmv_gnnz", "scaling", "percase"):
        if len(line) < 1500:
            break
        compact.pop(optional, None)
        line = _line()
    assert len(line) < 1500, f"driver line too long: {len(line)}"
    print(line)


if __name__ == "__main__":
    main()
