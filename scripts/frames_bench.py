"""Benchmark the frame-structure (StAn-like) family end to end.

Second-family validation (reference data_set.py:141-219 intent): the
full protocol — symmetric Jacobi scaling, FSAI plans, per-case AND
batched benchmark — on stiffness matrices with 6-dof nodes and 12x12
beam couplings (data/frames.py), a matrix class disjoint from the FVM
pressure-Poisson training distribution.  Writes
assets/results/frames/{table,totals,batched}.csv.

Usage: python scripts/frames_bench.py [--power 2] [--cases 200]
       [--checkpoint assets/checkpoints_frames/best.npz]
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def ensure_dataset(root: Path, samples: int) -> None:
    out = root / "frame_structures"
    if out.exists() and len(list(out.glob("case_*"))) >= samples:
        return
    from deeppreconditioning_tpu.data.frames import generate_frame_case
    from deeppreconditioning_tpu.data.fvm import save_case

    rng = np.random.default_rng(69422)
    for i in range(samples):
        save_case(generate_frame_case(rng), out / f"case_{i:04d}")


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--power", type=int, default=2)
    parser.add_argument("--cases", type=int, default=200)
    parser.add_argument("--timing-reps", type=int, default=10)
    parser.add_argument(
        "--checkpoint",
        default=str(REPO / "assets" / "checkpoints_frames"
                    / "best.npz"),
    )
    parser.add_argument("--platform", default=None,
                        choices=["cpu", "gpu"])
    args = parser.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    from deeppreconditioning_tpu.bench.suite import BenchmarkSuite
    from deeppreconditioning_tpu.config import params_show
    from deeppreconditioning_tpu.data.datasets import SludgePatternDataSet
    from deeppreconditioning_tpu.models import NeuralFSAI, plan_builder_for
    from deeppreconditioning_tpu.train.trainer import load_checkpoint

    params = params_show(REPO / "params.yaml")
    root = REPO / params.data_root
    ensure_dataset(root, args.cases)

    specs = plan_builder_for("NeuralFSAI", None)
    ds = SludgePatternDataSet(
        stage="test", batch_size=1, specs=specs, shuffle=False,
        root=root, family="frame_structures",
    )

    model = model_params = None
    learned_power = args.power
    ckpt = Path(args.checkpoint)
    if ckpt.exists():
        payload = load_checkpoint(ckpt)
        model = NeuralFSAI(
            width=int(payload["width"]),
            hidden=int(payload.get("hidden", 64)),
            poly_degree=int(payload.get("poly_degree", 1)),
        )
        model_params = payload["params"]
        learned_power = int(payload.get("power", args.power))

    techniques = ["vanilla", "jacobi", "incomplete_cholesky", "fsai"]
    if model is not None:
        techniques.append("learned")
    suite = BenchmarkSuite(
        ds, model, model_params,
        techniques=tuple(techniques),
        kappa_cases=1,
        timing_reps=args.timing_reps,
        fsai_power=args.power,
        learned_power=learned_power,
        results_directory=REPO / "assets" / "results" / "frames",
    )
    suite.run(verbose=False)
    suite.dump_csv()
    out = {
        name: {
            "iterations": round(stats["iterations"], 2),
            "kappa": round(stats["kappa"], 2),
            "total_ms": round(stats["total"] * 1e3, 3),
            "success": stats["success"],
        }
        for name, stats in suite.summary().items()
    }
    try:
        batched = suite.run_batched()
        suite.dump_csv_batched()
        out["batched"] = {
            name: {
                "iterations": round(s["iterations"], 2),
                "total_ms": round(s["total_batch"] * 1e3, 2),
                "success": s["success"],
            }
            for name, s in batched.items()
        }
    except Exception as exc:  # pragma: no cover - diagnostics only
        out["batched_error"] = str(exc)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
